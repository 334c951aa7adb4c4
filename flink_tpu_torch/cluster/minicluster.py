"""MiniCluster: multi-subtask parallel job execution in one process (port of
``flink_tpu/cluster/minicluster.py``).

Analog of the reference's ``MiniCluster.java`` (Dispatcher + JobMaster +
TaskExecutors in one JVM with real RPC/network/checkpointing): deploys an
``ExecutionPlan`` with REAL parallelism — one thread per subtask, bounded
channels between them (credit-style backpressure), hash/rebalance/broadcast
partitioners on the edges — plus a **CheckpointCoordinator**
(``CheckpointCoordinator.java:96``): periodic triggers to source subtasks,
in-band barriers (aligned or unaligned), ack collection, completed-checkpoint
store and ``notifyCheckpointComplete`` fan-out, and failure recovery by
restarting the job from the latest completed checkpoint
(restart-strategy analog, full-restart region).

Checkpoint layout: ``{uid: {"subtasks": [per-subtask snapshot, ...]}}`` plus
``__job__`` metadata.  On restore with the same parallelism each subtask gets
its own snapshot back; sources replay from their recorded offsets.

The port's copy of ``flink_tpu/cluster/minicluster.py``.  Subtasks are
threads, and PyTorch dispatches from many threads onto one card: each
subtask's operators hold their device explicitly (the environment's,
resolved when the job's operators are built), so no subtask depends on the
thread's current CUDA device.  The device watchdog is process-wide, so a
quarantine degrades every subtask on the card.  On region failover the
cancelled subtasks close their operators (device state, pager rings and C
mirrors are freed) before the restarted attempt builds its own.

Every ``queryable=<name>`` operator's live views register with the job's
serving tier (``queryable/service.py``) at deploy, with a checkpoint
replica per state fed by the completed checkpoints.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from flink_tpu_torch.cluster.channels import LocalChannel, OutputDispatcher
from flink_tpu_torch.cluster.task import (SourceSubtask, Subtask, SubtaskBase,
                                    TaskListener, TaskStates)
from flink_tpu_torch.core.functions import RuntimeContext
from flink_tpu_torch.graph.stream_graph import ExecutionPlan, PlanVertex
from flink_tpu_torch.observability import tracing
from flink_tpu_torch.utils import clock


@dataclass
class _PendingCheckpoint:
    checkpoint_id: int
    expected: int
    #: monotone elapsed timer (injectable clock seam): expiry decisions
    #: never regress under a chaos ClockSkew backward step
    timer: "clock.MonotoneElapsed"
    #: trigger-time perf reading — the trigger→complete span endpoints
    t0_ns: int = 0
    acks: Dict[Tuple[str, int], Dict[str, Any]] = field(default_factory=dict)
    #: OperatorCoordinator snapshots taken at TRIGGER time (the reference
    #: snapshots SourceCoordinator state before triggering tasks, §3.4)
    enumerators: Optional[Dict[str, Any]] = None


def _vertex_watermark(tasks) -> Optional[int]:
    """Min current watermark across a vertex's subtasks (the per-vertex
    ``currentInputWatermark`` metric the reference UI shows), or None
    before any watermark arrived."""
    from flink_tpu_torch.core.batch import LONG_MIN

    wms = []
    for t in tasks:
        valve = getattr(t, "_valve", None)
        if valve is not None:
            wms.append(valve.current)
        else:
            op_wm = getattr(t.operator, "watermark", None)
            if isinstance(op_wm, int):
                wms.append(op_wm)
    if not wms or any(w == LONG_MIN for w in wms):
        return None                     # not established vertex-wide yet
    return min(wms)


def _state_size(tree) -> int:
    """Approximate serialized checkpoint size: array nbytes + byte-string
    lengths through the nested snapshot (cheap — no re-pickling)."""
    import numpy as np

    if isinstance(tree, dict):
        return sum(_state_size(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_state_size(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    if isinstance(tree, (bytes, bytearray)):
        return len(tree)
    return 8


@dataclass
class JobResult:
    job_name: str
    state: str                      # FINISHED / FAILED / CANCELED
    net_runtime_ms: float
    restarts: int = 0
    completed_checkpoints: List[int] = field(default_factory=list)
    error: Optional[str] = None


class MiniCluster(TaskListener):
    #: synthetic "vertex" charged with checkpoint-policy failures: never in
    #: any plan, so region lookup falls back to a FULL restart
    _CHECKPOINT_COORDINATOR_UID = "__checkpoint_coordinator__"

    def __init__(self, checkpoint_storage=None, checkpoint_interval_ms: int = 0,
                 unaligned: bool = False, checkpoint_timeout_s: float = 60.0,
                 restart_attempts: int = 0, restart_delay_ms: int = 50,
                 channel_capacity: int = 32, restart_strategy=None,
                 config=None, tolerable_failed_checkpoints: int = 0,
                 alignment_timeout_ms: Optional[float] = None,
                 alignment_queue_max: Optional[int] = None,
                 latency_interval_ms: Optional[int] = None,
                 tracing_enabled: Optional[bool] = None,
                 queryable_replicas: int = 1,
                 incremental: bool = False):
        from flink_tpu_torch.cluster.failover import (FixedDelayRestartStrategy,
                                                NoRestartStrategy)
        from flink_tpu_torch.config.options import (CheckpointingOptions,
                                              MetricOptions, StateOptions)
        from flink_tpu_torch.observability import LatencyTracker
        from flink_tpu_torch.observability import tracing as tracing_mod
        from flink_tpu_torch.runtime.checkpoint.failure import \
            CheckpointFailureManager

        self.config = config
        # unaligned-checkpoint policy: explicit args win, then config keys,
        # then the option defaults (aligned, 8192-element queue cap)
        if config is not None:
            if not unaligned:
                unaligned = bool(config.get(CheckpointingOptions.UNALIGNED))
            if alignment_timeout_ms is None:
                alignment_timeout_ms = config.get(
                    CheckpointingOptions.ALIGNMENT_TIMEOUT)
        # latency tracking + tracing: explicit args win, then the
        # metrics.latency.interval / metrics.tracing.* config keys
        if latency_interval_ms is None and config is not None:
            latency_interval_ms = config.get(MetricOptions.LATENCY_INTERVAL)
        self.latency_interval_ms = int(latency_interval_ms or 0)
        if tracing_enabled is None and config is not None:
            tracing_enabled = bool(config.get(MetricOptions.TRACING_ENABLED))
        self.tracing_enabled = bool(tracing_enabled)
        #: THIS cluster's journal handle: job_status()/trace_events() read
        #: it instead of the process singleton, so a tracing-off job in
        #: the same process never reports another job's spans as its own
        self._trace_journal = None
        #: True only when THIS cluster installed the journal: an adopted
        #: pre-existing journal belongs to whoever installed it (a bench
        #: harness, an outer job) — we record into it but never reset()
        #: it, and its owner's capacity choice wins over config
        self._owns_trace_journal = False
        if self.tracing_enabled:
            cap = (config.get(MetricOptions.TRACING_BUFFER)
                   if config is not None
                   else MetricOptions.TRACING_BUFFER.default)
            self._trace_journal, self._owns_trace_journal = \
                tracing_mod.adopt_or_install(cap)
        #: per-(source, operator-hop) latency histograms fed by the
        #: LatencyMarker flow; bound to the job metric group below so
        #: every reporter (Prometheus summaries included) exports them
        self.latency_tracker = LatencyTracker()
        if alignment_queue_max is None:
            alignment_queue_max = (
                config.get(CheckpointingOptions.ALIGNMENT_QUEUE_MAX)
                if config is not None
                else CheckpointingOptions.ALIGNMENT_QUEUE_MAX.default)
        self.alignment_timeout_ms = alignment_timeout_ms
        self.alignment_queue_max = alignment_queue_max
        #: queryable serving tier: N-replica read fan-out per state
        #: (reads load-balance across the freshest members; a partitioned
        #: member's traffic fails over to a sibling)
        self.queryable_replicas = max(1, int(queryable_replicas))
        #: last completed checkpoint's alignment accounting (job_status()
        #: ["checkpoints"] + the lastCheckpoint* gauges)
        self._last_alignment: Dict[str, Any] = {
            "last_alignment_duration_ms": 0.0, "last_overtaken_bytes": 0,
            "last_persisted_inflight_bytes": 0, "unaligned_checkpoints": 0}
        #: execution.checkpointing.tolerable-failed-checkpoints analog:
        #: declined/timed-out/storage-failed checkpoints beyond this many
        #: CONSECUTIVE failures trigger job failover (-1 = unlimited)
        self.failure_manager = CheckpointFailureManager(
            tolerable_failed_checkpoints)
        self.checkpoint_storage = checkpoint_storage
        self.checkpoint_interval_ms = checkpoint_interval_ms
        self.unaligned = unaligned
        # incremental (delta) checkpoints: explicit arg wins, then the
        # state.backend.incremental config key
        if not incremental and config is not None:
            incremental = bool(config.get(StateOptions.INCREMENTAL))
        self.incremental = bool(incremental)
        self.incremental_rebase_ratio = float(
            config.get(CheckpointingOptions.INCREMENTAL_REBASE_RATIO)
            if config is not None
            else CheckpointingOptions.INCREMENTAL_REBASE_RATIO.default)
        self.changelog_materialization_threshold = int(
            config.get(StateOptions.CHANGELOG_MATERIALIZATION_THRESHOLD)
            if config is not None
            else StateOptions.CHANGELOG_MATERIALIZATION_THRESHOLD.default)
        self.checkpoint_timeout_s = checkpoint_timeout_s
        self.restart_attempts = restart_attempts
        self.restart_delay_ms = restart_delay_ms
        self.channel_capacity = channel_capacity
        #: pluggable restart policy (fixed/exponential/failure-rate);
        #: restart_attempts kept as the back-compat shorthand
        self.restart_strategy = restart_strategy or (
            FixedDelayRestartStrategy(restart_attempts, restart_delay_ms)
            if restart_attempts > 0 else NoRestartStrategy())
        self._lock = threading.Lock()
        self._tasks: List[SubtaskBase] = []
        self._slot_memory_pool = None  # lazy: SlotMemoryPool
        self._pending: Optional[_PendingCheckpoint] = None
        self._completed_ids: List[int] = []
        self._next_checkpoint_id = 1
        self._failed: Optional[str] = None
        self._stop_requested = False
        # pre-deploy defaults: REST calls may land before execute()
        self._finished: set = set()
        self._source_tasks: List[SourceSubtask] = []
        self._subtask_counts: Dict[str, int] = {}
        #: per-checkpoint stats (CheckpointStatsTracker analog) — id,
        #: duration, state size; surfaced by REST + the dashboard
        self._checkpoint_stats: List[Dict[str, Any]] = []
        #: every task failure ever seen (JobExceptionsHandler's history,
        #: not just the current root cause); bounded
        self._exception_history: List[Dict[str, Any]] = []
        #: restarts performed by the CURRENT/most recent execute() —
        #: surfaced by job_status() next to the failed-checkpoint counters
        self._restarts = 0
        #: job-scope metric group: numberOfCompleted/FailedCheckpoints +
        #: numRestarts (CheckpointStatsTracker analogs) on a jobmanager
        #: root, so reporters attached to ``metrics_registry`` export them
        from flink_tpu_torch.metrics.groups import (MetricRegistry,
                                              backpressure_metrics,
                                              checkpoint_alignment_metrics,
                                              device_health_metrics,
                                              job_checkpoint_metrics)
        self.metrics_registry = MetricRegistry()
        self.job_metric_group = job_checkpoint_metrics(
            self.metrics_registry.job_manager_group(), self.failure_manager,
            lambda: self._restarts)
        #: device-lane health gauges (runtime/device_health.py): the
        #: process-wide monitor's state + this job's degraded operators
        device_health_metrics(self.job_metric_group,
                              self.device_health_status)
        #: channel backpressure + unaligned-checkpoint alignment gauges
        backpressure_metrics(self.job_metric_group, self.backpressure_totals)
        checkpoint_alignment_metrics(self.job_metric_group,
                                     lambda: self._last_alignment)
        #: latency.* histogram + p50/p99 gauge export rides the same group
        self.latency_tracker.bind_group(self.job_metric_group)
        #: queryable serving tier: auto-wired at deploy when any
        #: operator was built with ``queryable=<name>`` — live views per
        #: subtask + a checkpoint replica fed from _complete_checkpoint
        self.queryable = None
        #: reactive-autoscaler status supplier (cluster/adaptive.py
        #: ReactiveAutoscaler attaches it to each cluster it deploys):
        #: surfaces as ``job_status()["autoscaler"]`` + autoscaler.* gauges
        self.autoscaler_status_supplier = None
        #: coordinator HA: optional callable(checkpoint_id) ->
        #: bool consulted BEFORE a completed checkpoint is stored/notified
        #: — the leader-epoch fence (e.g. FileHaStore pointer advance).
        #: False/raise = this coordinator is a zombie ex-leader: the
        #: completion aborts (no store, no notify, so 2PC never commits)
        #: and the failure budget is charged
        self.ha_commit_gate = None
        #: completions this cluster lost to the HA fence
        self.ha_fenced_completions = 0
        #: HA panel supplier: surfaces as ``job_status()["ha"]`` + the
        #: ``/jobs/<id>/ha`` REST endpoint
        self.ha_status_supplier = None
        from flink_tpu_torch.metrics.groups import ha_metrics

        def _ha_status():
            if self.ha_status_supplier is None:
                return None
            try:
                return self.ha_status_supplier()
            except Exception:  # noqa: BLE001 — gauges never raise
                return None
        ha_metrics(self.job_metric_group, _ha_status)

    # ------------------------------------------------------------ listener
    def _slot_memory(self):
        """The next slot's managed-memory accountant (round-robin over the
        executor's fixed slot pool — TaskManagerOptions sizing; restarts
        REUSE slots, so aggregate managed memory stays bounded)."""
        from flink_tpu_torch.runtime.memory import SlotMemoryPool

        if self._slot_memory_pool is None:
            self._slot_memory_pool = SlotMemoryPool(self.config)
        return self._slot_memory_pool.assign()

    def task_state_changed(self, vertex_uid: str, subtask_index: int,
                           state: str, error: Optional[str]) -> None:
        if state == TaskStates.FAILED:
            with self._lock:
                if self._failed is None:
                    self._failed = f"{vertex_uid}[{subtask_index}]: {error}"
                self._exception_history.append({
                    "timestamp_ms": int(time.time() * 1000),
                    "task": f"{vertex_uid}[{subtask_index}]",
                    "exception": str(error)})
                del self._exception_history[:-50]   # bounded history
        elif state == TaskStates.FINISHED:
            with self._lock:
                self._finished.add((vertex_uid, subtask_index))
                # a task finishing mid-alignment will never ack: shrink the
                # expectation so the checkpoint can still complete
                p = self._pending
                if p is not None and (vertex_uid, subtask_index) not in p.acks:
                    p.expected -= 1
                    if len(p.acks) >= p.expected and self._cut_whole(p):
                        # claims self._pending; a NEW checkpoint may start
                        # during its unlocked store, so don't clear after
                        self._complete_checkpoint(p)

    def acknowledge_checkpoint(self, checkpoint_id: int, vertex_uid: str,
                               subtask_index: int,
                               snapshot: Dict[str, Any]) -> None:
        with self._lock:
            p = self._pending
            if p is None or p.checkpoint_id != checkpoint_id:
                return  # late ack for an aborted checkpoint: decline
            # instant AFTER the validity check: a declined late ack must
            # not show up on the timeline as a real lifecycle event (the
            # trigger→complete span's acked count and the ack instants
            # would disagree)
            tracing.instant("checkpoint.ack", cat="checkpoint",
                            checkpoint=checkpoint_id, task=vertex_uid,
                            subtask=subtask_index)
            p.acks[(vertex_uid, subtask_index)] = snapshot
            if len(p.acks) >= p.expected and self._cut_whole(p):
                self._complete_checkpoint(p)

    def _cut_whole(self, p: _PendingCheckpoint) -> bool:
        """Caller holds ``_lock``.  Every task of the deployment has acked
        ``p`` or finished with its final snapshot.  The ack count alone
        (JAX's MiniCluster completes on it) has run ahead of that at a
        stream's tail under rescales: a checkpoint completed with neither
        an ack nor a final snapshot from a running subtask, and the
        autoscaler's cut restored that subtask with no state, losing its
        unfired windows.  Such a checkpoint waits for the task instead, or
        times out."""
        for t in self._tasks:
            key = (t.vertex_uid, t.subtask_index)
            if key not in p.acks and (
                    key not in self._finished
                    or getattr(t, "final_snapshot", None) is None):
                return False
        return True

    def decline_checkpoint(self, checkpoint_id: int, vertex_uid: str,
                           subtask_index: int, error: str) -> None:
        """A subtask could not snapshot: abort the pending checkpoint and
        charge the failure budget (``receiveDeclineMessage`` analog)."""
        from flink_tpu_torch.runtime.checkpoint.failure import \
            CheckpointFailureReason

        with self._lock:
            p = self._pending
            if p is None or p.checkpoint_id != checkpoint_id:
                return                       # already aborted/completed
            self._pending = None
            self._record_checkpoint_failure(
                CheckpointFailureReason.DECLINED, checkpoint_id,
                f"{vertex_uid}[{subtask_index}] declined: {error}")

    def _record_checkpoint_failure(self, reason: str, checkpoint_id: int,
                                   detail: str) -> None:
        """Caller holds ``_lock``.  Counts one in-flight checkpoint failure;
        past the tolerable budget the JOB fails over (the execute loop's
        restart strategy takes it from there, full-restart region)."""
        exceeded = self.failure_manager.on_checkpoint_failure(
            reason, checkpoint_id)
        self._exception_history.append({
            "timestamp_ms": int(time.time() * 1000),
            "task": f"checkpoint-{checkpoint_id}",
            "exception": f"checkpoint {reason}: {detail}"})
        del self._exception_history[:-50]
        if exceeded and self._failed is None:
            self._failed = (
                f"{self._CHECKPOINT_COORDINATOR_UID}[0]: tolerable failed "
                f"checkpoints ({self.failure_manager.tolerable}) exceeded — "
                f"checkpoint {checkpoint_id} {reason}: {detail}")

    def _complete_checkpoint(self, p: _PendingCheckpoint) -> None:
        assembled: Dict[str, Any] = {"__job__": {
            "checkpoint_id": p.checkpoint_id,
            "parallelism": {uid: n for uid, n in self._subtask_counts.items()},
        }}
        if p.enumerators:
            assembled["__enumerators__"] = p.enumerators
        for (uid, idx), snap in p.acks.items():
            entry = assembled.setdefault(
                uid, {"subtasks": [None] * self._subtask_counts[uid]})
            entry["subtasks"][idx] = snap
        # finished tasks no longer ack: carry their FINAL snapshots so the
        # checkpoint stays a complete consistent cut (FLIP-147 analog)
        for t in self._tasks:
            key = (t.vertex_uid, t.subtask_index)
            if key in self._finished and key not in p.acks:
                final = getattr(t, "final_snapshot", None)
                if final is not None:
                    entry = assembled.setdefault(
                        t.vertex_uid,
                        {"subtasks": [None] * self._subtask_counts[t.vertex_uid]})
                    entry["subtasks"][t.subtask_index] = final
        # claim completion BEFORE dropping the lock for storage I/O: late
        # acks/declines for this id are ignored and a new trigger may start
        self._pending = None
        from flink_tpu_torch.runtime.checkpoint.failure import \
            CheckpointFailureReason
        # coordinator HA: the leader-epoch fence — a zombie
        # ex-leader's completion must abort here, BEFORE bytes land and
        # before any notify fans out (so its 2PC epochs never commit)
        if self.ha_commit_gate is not None:
            try:
                admitted = bool(self.ha_commit_gate(p.checkpoint_id))
            except Exception as e:  # noqa: BLE001 — fence errors = fenced
                admitted = False
                fence_detail = f"{type(e).__name__}: {e}"
            else:
                fence_detail = "stale leader epoch"
            if not admitted:
                self.ha_fenced_completions += 1
                self._record_checkpoint_failure(
                    CheckpointFailureReason.STORAGE, p.checkpoint_id,
                    f"fenced by HA commit gate: {fence_detail}")
                return
        # incremental checkpoints: delta-tracking operators acked increment
        # nodes — resolve them against the previous completed checkpoint's
        # RESOLVED tree so everything downstream (queryable replicas,
        # rescale, in-memory restore) keeps consuming the dense interchange
        # format.  Increment-capable storage persists the RAW tree (bytes
        # scale with the change rate); every other storage gets the
        # self-contained resolved cut.
        from flink_tpu_torch.runtime.checkpoint import delta
        has_delta = delta.tree_has_increment(assembled)
        if has_delta:
            try:
                resolved = delta.apply_increments(
                    getattr(self, "_latest_snapshot", None), assembled)
            except delta.IncrementChainError as e:
                self._record_checkpoint_failure(
                    CheckpointFailureReason.STORAGE, p.checkpoint_id,
                    f"IncrementChainError: {e}")
                return
        else:
            resolved = assembled
        if self.checkpoint_storage is not None:
            store_tree = assembled if (has_delta and getattr(
                self.checkpoint_storage, "supports_increments", False)) \
                else resolved
            # the store (and any retry/backoff wrapper around it) must not
            # stall the coordinator lock: acks, declines and triggers keep
            # flowing while the bytes land
            self._lock.release()
            try:
                try:
                    self.checkpoint_storage.store(p.checkpoint_id, store_tree)
                except Exception as e:  # noqa: BLE001
                    store_error = f"{type(e).__name__}: {e}"
                else:
                    store_error = None
            finally:
                self._lock.acquire()
            if store_error is not None:
                # a storage flake must not kill the ACKING TASK's thread
                # (store runs on it): the checkpoint is abandoned, the
                # failure budget charged, the job keeps running — or fails
                # over once the budget is exhausted
                self._record_checkpoint_failure(
                    CheckpointFailureReason.STORAGE, p.checkpoint_id,
                    store_error)
                return
        self.failure_manager.on_checkpoint_success(p.checkpoint_id)
        self._completed_ids.append(p.checkpoint_id)
        self._latest_snapshot = resolved
        if self.queryable is not None:
            # feed the read replicas off the checkpoint stream: enqueue
            # only (the replica's own ingest thread parses the snapshot —
            # the acking task thread never does serving-tier work)
            self.queryable.on_checkpoint_complete(p.checkpoint_id, resolved)
        # aggregate the subtasks' channel-state (v1) alignment accounting
        # (one shared reader of the schema: task.aggregate_channel_state)
        from flink_tpu_torch.cluster.task import aggregate_channel_state
        agg = aggregate_channel_state(p.acks.values())
        self._last_alignment = {
            "last_alignment_duration_ms": agg["alignment_ms"],
            "last_overtaken_bytes": agg["overtaken_bytes"],
            "last_persisted_inflight_bytes":
                agg["persisted_inflight_bytes"],
            "unaligned_checkpoints":
                self._last_alignment.get("unaligned_checkpoints", 0)
                + int(agg["unaligned"])}
        size = _state_size(resolved)
        # trigger→complete span: the whole lifecycle on one timeline row
        if p.t0_ns:
            tracing.complete("checkpoint", p.t0_ns, time.perf_counter_ns(),
                             cat="checkpoint", checkpoint=p.checkpoint_id,
                             state_size_bytes=size, acked=len(p.acks),
                             unaligned=bool(agg["unaligned"]))
        self._checkpoint_stats.append({
            "id": p.checkpoint_id,
            "completed_at_ms": int(time.time() * 1000),
            "duration_ms": round(p.timer.ms(), 1),
            "state_size_bytes": size,
            # full-vs-delta accounting: what was acked/persisted this cut
            # (== state_size_bytes for a full cut)
            "incremental": has_delta,
            "delta_bytes": _state_size(assembled) if has_delta else size,
            "acked_subtasks": len(p.acks),
            **agg})
        del self._checkpoint_stats[:-100]           # bounded history
        for t in self._tasks:
            t.commands.put(("notify_complete", p.checkpoint_id))

    # ------------------------------------------------------------ deploy
    def _deploy(self, plan: ExecutionPlan,
                restore: Optional[Dict[str, Any]],
                _keep_tasks: Optional[List[SubtaskBase]] = None) -> None:
        self._tasks = list(_keep_tasks or [])
        if _keep_tasks is None:
            self._failed = None
            self._pending = None
            self._finished = set()
        source_tasks: List[SourceSubtask] = [
            t for t in self._tasks if isinstance(t, SourceSubtask)]
        subtask_counts: Dict[str, int] = {}
        # source parallelism = split count (one SourceSubtask per split),
        # EXCEPT runtime-enumerated sources (FLIP-27 coordination): fixed
        # reader count, splits assigned on request by the coordinator
        from flink_tpu_torch.connectors.enumerator import SourceCoordinator
        if _keep_tasks is None or not hasattr(self, "_source_coordinator"):
            self._source_coordinator = SourceCoordinator()
        splits_by_vertex: Dict[int, list] = {}
        dynamic_sources: set = set()
        for v in plan.vertices:
            if v.is_source:
                src = v.chain[0].source
                enum_factory = getattr(src, "create_enumerator", None)
                if enum_factory is not None:
                    dynamic_sources.add(v.id)
                    # region restart (_keep_tasks) keeps the LIVE enumerator
                    # — its assigned-set must survive; only a fresh deploy
                    # (full restart restores it from the checkpoint) builds
                    # a new one
                    if _keep_tasks is None or \
                            v.uid not in self._source_coordinator._enums:
                        self._source_coordinator.register(v.uid,
                                                          enum_factory())
                    subtask_counts[v.uid] = v.parallelism
                    continue
                splits = src.create_splits(v.parallelism)
                splits_by_vertex[v.id] = splits
                subtask_counts[v.uid] = max(1, len(splits))
            else:
                subtask_counts[v.uid] = v.parallelism
        if _keep_tasks is None:
            self._subtask_counts = subtask_counts
        else:
            self._subtask_counts.update(subtask_counts)

        def n_subs(v: PlanVertex) -> int:
            return subtask_counts[v.uid]

        # channels per edge: producer subtask x consumer subtask
        inputs: Dict[int, List[List[LocalChannel]]] = {
            v.id: [[] for _ in range(n_subs(v))] for v in plan.vertices}
        input_logical: Dict[int, List[List[int]]] = {
            v.id: [[] for _ in range(n_subs(v))] for v in plan.vertices}
        #: per-input-channel routing metadata (key column / partitioning /
        #: producer max-parallelism / logical port): Subtasks write it
        #: into the v2 channel-state section so persisted in-flight
        #: elements can be re-routed BY KEY on a rescale restore
        input_routing: Dict[int, List[List[Dict[str, Any]]]] = {
            v.id: [[] for _ in range(n_subs(v))] for v in plan.vertices}

        def edge_routing(e, v) -> Dict[str, Any]:
            return {"partitioning": e.partitioning,
                    "key_column": e.key_column,
                    "max_parallelism": v.max_parallelism,
                    "logical": e.input_index}

        outputs: Dict[int, List[List[OutputDispatcher]]] = {
            v.id: [[] for _ in range(n_subs(v))] for v in plan.vertices}
        for v in plan.vertices:
            for e in v.out_edges:
                tgt = plan.by_id[e.target_id]
                np_, nc = n_subs(v), n_subs(tgt)
                for pi in range(np_):
                    part = e.partitioning
                    if part == "forward" and np_ == nc:
                        # FORWARD keeps subtask alignment (producer i ->
                        # consumer i): an upstream hash edge's key
                        # partitioning must survive unchained stateful
                        # consumers — rebalancing here would scatter keys
                        ch = LocalChannel(
                            self.channel_capacity,
                            name=f"{v.name}[{pi}]->{tgt.name}[{pi}]")
                        inputs[tgt.id][pi].append(ch)
                        input_logical[tgt.id][pi].append(e.input_index)
                        input_routing[tgt.id][pi].append(edge_routing(e, v))
                        outputs[v.id][pi].append(OutputDispatcher(
                            part, [ch], max_parallelism=v.max_parallelism,
                            subtask_index=pi, key_column=e.key_column))
                        continue
                    chans = [LocalChannel(self.channel_capacity,
                                          name=f"{v.name}[{pi}]->{tgt.name}[{ci}]")
                             for ci in range(nc)]
                    for ci, ch in enumerate(chans):
                        inputs[tgt.id][ci].append(ch)
                        input_logical[tgt.id][ci].append(e.input_index)
                        input_routing[tgt.id][ci].append(edge_routing(e, v))
                    # forward edges with MISMATCHED parallelism degrade to
                    # round-robin (the reference inserts rescale here)
                    if part == "forward" and nc > 1:
                        part = "rebalance"
                    outputs[v.id][pi].append(OutputDispatcher(
                        part, chans, max_parallelism=v.max_parallelism,
                        subtask_index=pi, key_column=e.key_column))

        # deploy barrier: no subtask of THIS deployment processes input
        # before every subtask finished open+restore (shared-instance sink
        # restores REPLACE rows — a sibling's pre-restore fire would be
        # wiped; rescale redeploys hit exactly that race).  Sized to the
        # tasks actually started below; kept-task region restarts gate
        # only the restarted region's tasks.
        n_new = sum(len(splits_by_vertex[v.id])
                    if v.is_source and v.id in splits_by_vertex
                    else subtask_counts[v.uid] for v in plan.vertices)
        self._deploy_gate = threading.Barrier(n_new) if n_new > 1 else None

        restore = restore or {}
        for v in plan.vertices:
            uid = v.uid
            vr = restore.get(uid, {})
            sub_snaps = vr.get("subtasks", [])
            if v.is_source:
                if v.id in dynamic_sources:
                    # runtime coordination: restore the enumerator, then
                    # reclaim every reader-owned in-flight split
                    enum_restore = (restore.get("__enumerators__") or {}) \
                        .get(uid)
                    coord = self._source_coordinator
                    if enum_restore is not None:
                        coord._enums[uid].restore_state(enum_restore)
                    for s in sub_snaps:
                        if not s:
                            continue
                        if s.get("current_split") is not None:
                            coord._enums[uid].reclaim(s["current_split"])
                        for fs in s.get("finished_splits", []):
                            coord._enums[uid].reclaim(fs)
                    for i in range(n_subs(v)):
                        ctx = RuntimeContext(
                            task_name=v.name, subtask_index=i,
                            parallelism=n_subs(v),
                            max_parallelism=v.max_parallelism,
                            memory_manager=self._slot_memory())
                        requester = (lambda u=uid, ri=i:
                                     coord.request_split(u, ri))
                        t = SourceSubtask(uid, i, v.build_operator(),
                                          outputs[v.id][i], ctx, self, None,
                                          split_requester=requester)
                        self._attach_observability(t)
                        t.start(sub_snaps[i] if i < len(sub_snaps) else None)
                        self._tasks.append(t)
                        source_tasks.append(t)
                    continue
                splits = splits_by_vertex[v.id]
                for i, split in enumerate(splits):
                    ctx = RuntimeContext(task_name=v.name, subtask_index=i,
                                         parallelism=len(splits),
                                         max_parallelism=v.max_parallelism,
                                         memory_manager=self._slot_memory())
                    t = SourceSubtask(uid, i, v.build_operator(),
                                      outputs[v.id][i], ctx, self, split)
                    self._attach_observability(t)
                    t.start(sub_snaps[i] if i < len(sub_snaps) else None)
                    self._tasks.append(t)
                    source_tasks.append(t)
            else:
                for i in range(n_subs(v)):
                    ctx = RuntimeContext(task_name=v.name, subtask_index=i,
                                         parallelism=n_subs(v),
                                         max_parallelism=v.max_parallelism,
                                         memory_manager=self._slot_memory())
                    t = Subtask(uid, i, v.build_operator(), outputs[v.id][i],
                                ctx, self, inputs[v.id][i],
                                unaligned=self.unaligned,
                                input_logical=input_logical[v.id][i],
                                alignment_timeout_ms=self.alignment_timeout_ms,
                                alignment_queue_max=self.alignment_queue_max,
                                input_routing=input_routing[v.id][i])
                    self._attach_observability(t)
                    t.start(sub_snaps[i] if i < len(sub_snaps) else None)
                    self._tasks.append(t)
        self._source_tasks = source_tasks
        # job-scope paging occupancy gauges (idempotent registration): only
        # when a deployed operator actually pages device state
        if any(self._iter_paged_operators()):
            from flink_tpu_torch.metrics.groups import paging_metrics
            paging_metrics(self.job_metric_group, self.paging_totals)
        self._wire_queryable(plan)

    def _attach_observability(self, t: SubtaskBase) -> None:
        """Wire latency tracking + the deploy barrier into a subtask
        BEFORE it starts: every hop records markers into the shared
        tracker, sources get the ``metrics.latency.interval`` emission
        cadence, and no subtask processes input until the whole
        deployment finished restoring."""
        t.latency_tracker = self.latency_tracker
        t._deploy_gate = getattr(self, "_deploy_gate", None)
        if isinstance(t, SourceSubtask) and self.latency_interval_ms:
            t.latency_marker_interval_ms = self.latency_interval_ms
        if self.incremental:
            # delta checkpoints: the subtask opens the snapshot scope with
            # incremental=True (savepoints/finals excepted) and every
            # delta-capable operator in the chain starts dirty tracking
            t.incremental_checkpoints = True
            for member in getattr(t.operator, "operators", [t.operator]):
                if hasattr(member, "incremental_state"):
                    member.incremental_state = True
                    if hasattr(member, "incr_rebase_ratio"):
                        member.incr_rebase_ratio = \
                            self.incremental_rebase_ratio
                be = getattr(member, "backend", None)
                if be is not None and hasattr(be, "snapshot_increment"):
                    be.materialize_threshold = \
                        self.changelog_materialization_threshold

    def _wire_queryable(self, plan: ExecutionPlan) -> None:
        """Register every ``queryable=<name>`` operator's live views with
        the serving tier and stand up a checkpoint replica per state.
        Re-deploys (restarts, region recovery) RE-register views — the
        rebuilt operators publish fresh — while replicas persist (their
        last ingested checkpoint keeps serving through the restart)."""
        regs: Dict[str, Dict[str, Any]] = {}
        for t in self._tasks:
            op = t.operator
            for member in getattr(op, "operators", [op]):
                qname = getattr(member, "queryable", None)
                view = getattr(member, "queryable_view", lambda: None)()
                if qname is None or view is None:
                    continue
                entry = regs.setdefault(qname, {"uid": t.vertex_uid,
                                                "views": {}, "op": member})
                entry["views"][t.subtask_index] = view
        if not regs:
            return
        if self.queryable is None:
            from flink_tpu_torch.metrics.groups import queryable_metrics
            from flink_tpu_torch.queryable.service import QueryableStateService
            self.queryable = QueryableStateService()
            queryable_metrics(self.job_metric_group,
                              lambda: (self.queryable.stats()
                                       if self.queryable else None))
        max_par = {v.uid: v.max_parallelism
                   for v in plan.vertices} if plan is not None else {}
        for name, entry in regs.items():
            p = self._subtask_counts.get(entry["uid"], len(entry["views"]))
            views = [entry["views"].get(i) for i in range(p)]
            from flink_tpu_torch.queryable.view import WindowReadView
            views = [v if v is not None else WindowReadView(
                entry["op"].key_column) for v in views]
            self.queryable.register_views(
                name, views, parallelism=p,
                max_parallelism=max_par.get(entry["uid"], 128))
            if name not in self.queryable.registry.replicas():
                from flink_tpu_torch.queryable.replica import QueryableStateSpec
                self.queryable.add_replica(
                    name, QueryableStateSpec.from_operator(
                        name, entry["uid"], entry["op"]),
                    max_parallelism=max_par.get(entry["uid"], 128),
                    replicas=self.queryable_replicas)

    def start_queryable_server(self, host: str = "127.0.0.1", port: int = 0):
        """Start (or return) the job's TCP queryable-state server
        (``KvStateServerImpl`` analog) fronting the serving tier."""
        if self.queryable is None:
            from flink_tpu_torch.queryable.service import QueryableStateService
            self.queryable = QueryableStateService()
        return self.queryable.start_server(host=host, port=port)

    def _iter_paged_operators(self):
        for t in getattr(self, "_tasks", []):
            op = t.operator
            for member in getattr(op, "operators", [op]):
                if getattr(member, "_pager", None) is not None:
                    yield member

    def device_health_status(self) -> Dict[str, Any]:
        """Process-wide device-lane health + this job's per-operator tier
        counters (``job_status()["device_health"]`` and the
        ``device_health.*`` gauges).  Monitoring-grade: reads no operator
        state behind a barrier."""
        from flink_tpu_torch.runtime import device_health
        status = device_health.status_snapshot()
        degraded = migrations = repromotions = 0
        for t in getattr(self, "_tasks", []):
            op = t.operator
            for member in getattr(op, "operators", [op]):
                stats_fn = getattr(member, "device_health_stats", None)
                if stats_fn is None:
                    continue
                st = stats_fn()
                degraded += st.get("degraded", 0)
                migrations += st.get("quarantine_migrations", 0)
                repromotions += st.get("repromotions", 0)
        status["degraded_operators"] = degraded
        status["quarantine_migrations"] = migrations
        status["repromotions"] = repromotions
        return status

    def paging_totals(self) -> Optional[Dict[str, int]]:
        """Aggregated ``paging_stats()`` across every paged operator
        (job_status()["paging"] + the job-scope ``paging.*`` gauges)."""
        total: Optional[Dict[str, int]] = None
        for member in self._iter_paged_operators():
            st = member.paging_stats()
            if not st:
                continue
            if total is None:
                total = dict(st)
            else:
                for k, v in st.items():
                    total[k] = total.get(k, 0) + v
        return total

    def backpressure_totals(self) -> Dict[str, Any]:
        """Aggregated channel backpressure view (the ``backpressure.*``
        gauges): total producer credit-wait time, deepest input queue, and
        elements currently buffered by barrier alignment.  Monitoring-grade
        — reads channel counters only, no operator state."""
        total_ms = 0.0
        max_depth = 0
        queued = 0
        for t in getattr(self, "_tasks", []):
            chan_fn = getattr(t, "channel_stats", None)
            if chan_fn is None:
                continue
            for c in chan_fn():
                total_ms += c["backpressured_ms"]
                max_depth = max(max_depth, c["depth"])
            queued += t.alignment_queued
        return {"total_backpressured_ms": round(total_ms, 3),
                "max_queue_depth": max_depth,
                "alignment_queued_elements": queued}

    # ------------------------------------------------------------ triggers
    def trigger_checkpoint(self) -> Optional[int]:
        cid, _reason = self._trigger_checkpoint()
        return cid

    def _trigger_checkpoint(self, savepoint: bool = False
                            ) -> Tuple[Optional[int], str]:
        """Start one checkpoint: inject barriers at all sources (RPC analog,
        ``CheckpointCoordinator.triggerCheckpoint:502``).  Returns
        ``(id, "ok")``, ``(None, "busy")`` while one is in flight, or
        ``(None, "declined")`` when checkpointing is no longer possible.
        ``savepoint=True`` marks the barriers so subtasks keep the
        snapshot ALIGNED even under escalation (rescalable by contract)."""
        from flink_tpu_torch.runtime.checkpoint.failure import \
            CheckpointFailureReason

        with self._lock:
            if self._pending is not None:
                # expiry reads the injectable clock seam through a MONOTONE
                # elapsed tracker: a ClockSkew backward step can neither
                # un-expire a checkpoint nor extend its deadline
                if (self._pending.timer.seconds()
                        < self.checkpoint_timeout_s):
                    return None, "busy"   # previous still in flight
                expired = self._pending
                self._pending = None  # timed out: abort
                self._record_checkpoint_failure(
                    CheckpointFailureReason.TIMEOUT, expired.checkpoint_id,
                    f"{len(expired.acks)}/{expired.expected} acks after "
                    f"{self.checkpoint_timeout_s}s")
            if not self._tasks:
                return None, "declined"   # nothing deployed yet
            # finished sources cannot inject barriers and finished tasks
            # never ack — decline once any source finished, exclude finished
            # tasks from the expectation otherwise
            if any((t.vertex_uid, t.subtask_index) in self._finished
                   for t in self._source_tasks):
                return None, "declined"
            expected = len(self._tasks) - len(self._finished)
            if expected <= 0:
                return None, "declined"
            cid = self._next_checkpoint_id
            self._next_checkpoint_id += 1
            tracing.instant("checkpoint.trigger", cat="checkpoint",
                            checkpoint=cid, savepoint=savepoint)
            self._pending = _PendingCheckpoint(
                cid, expected=expected, timer=clock.MonotoneElapsed(),
                t0_ns=time.perf_counter_ns())
            coord = getattr(self, "_source_coordinator", None)
            if coord is not None and coord._enums:
                self._pending.enumerators = coord.snapshot()
        for t in self._source_tasks:
            t.commands.put(("checkpoint", cid, savepoint))
        return cid, "ok"

    # ------------------------------------------------------------ execute
    def execute(self, plan: ExecutionPlan,
                restore: Optional[Dict[str, Any]] = None,
                timeout_s: float = 300.0) -> JobResult:
        from flink_tpu_torch.observability import tracing as tracing_mod

        if self.tracing_enabled:
            # one shared ownership state machine (see
            # tracing.acquire_for_execution): per-execution reset of an
            # owned ring, fresh owned ring when an adopted one's owner
            # released, (re-)adoption of whichever ring is actually live
            self._trace_journal, self._owns_trace_journal = \
                tracing_mod.acquire_for_execution(self._trace_journal,
                                                  self._owns_trace_journal)
        # the latency view is per execution too: job B's panel and
        # latency.* series must not mix in job A's hop rows/samples
        self.latency_tracker.reset()
        j, owned = self._trace_journal, self._owns_trace_journal
        try:
            return self._execute(plan, restore, timeout_s)
        finally:
            tracing_mod.release_after_execution(j, owned)

    def _execute(self, plan: ExecutionPlan,
                 restore: Optional[Dict[str, Any]],
                 timeout_s: float) -> JobResult:
        import copy as _copy

        if restore is not None:
            # a snapshot taken at a DIFFERENT parallelism (the autoscaler's
            # pre-rescale cut, an operator-resized redeploy) redistributes
            # through the key-group path — persisted in-flight channel
            # state included — instead of silently restoring positionally
            from flink_tpu_torch.cluster.adaptive import maybe_rescale_restore
            restore = maybe_rescale_restore(restore, plan)
        self._plan = plan              # dashboard DAG view
        t0 = time.monotonic()
        restarts = 0
        self._restarts = 0
        # restart budgets are per execution (per-ExecutionGraph in the
        # reference): a fresh strategy instance each run
        self._active_strategy = _copy.deepcopy(self.restart_strategy)
        self._deploy(plan, restore)
        # trigger cadence through the clock seam, monotone under skew
        trigger_timer = clock.MonotoneElapsed()
        while True:
            time.sleep(0.002)
            if time.monotonic() - t0 > timeout_s:
                self.cancel()
                return JobResult(plan.job_name, TaskStates.CANCELED,
                                 (time.monotonic() - t0) * 1000, restarts,
                                 self._completed_ids, "timeout")
            if self._failed is not None:
                err = self._failed
                failed_uid = err.split("[", 1)[0]
                self._active_strategy.notify_failure()
                if self._active_strategy.can_restart():
                    restarts += 1
                    self._restarts = restarts
                    # in-flight checkpoint attempts die with the execution:
                    # the continuous-failure window restarts too
                    self.failure_manager.on_job_restart()
                    time.sleep(self._active_strategy.delay_ms() / 1000.0)
                    try:
                        self._restart_failed_region(plan, failed_uid)
                    except Exception as e:  # noqa: BLE001 — stays a restart
                        # the restore's redistribute failed (a rescale's
                        # fault point) before any task was touched: the
                        # attempt counts as failed, and the next one
                        # redistributes the same immutable cut again
                        # (JAX's MiniCluster lets this escape execute())
                        with self._lock:
                            self._failed = (f"{failed_uid}[restart]: "
                                            f"{type(e).__name__}: {e}")
                    continue
                self.cancel()
                for t in self._tasks:
                    t.join()
                return JobResult(plan.job_name, TaskStates.FAILED,
                                 (time.monotonic() - t0) * 1000, restarts,
                                 self._completed_ids, err)
            states = [t.state for t in self._tasks]
            terminal = (TaskStates.FINISHED, TaskStates.CANCELED)
            if all(s in terminal for s in states):
                final = (TaskStates.FINISHED
                         if all(s == TaskStates.FINISHED for s in states)
                         else TaskStates.CANCELED)
                return JobResult(plan.job_name, final,
                                 (time.monotonic() - t0) * 1000, restarts,
                                 self._completed_ids)
            if (self.checkpoint_interval_ms and
                    trigger_timer.ms() >= self.checkpoint_interval_ms):
                if self.trigger_checkpoint() is not None:
                    trigger_timer = clock.MonotoneElapsed()

    def _restart_failed_region(self, plan: ExecutionPlan,
                               failed_uid: str) -> None:
        """Pipelined-region failover: restart only the connected component
        containing the failed vertex (``RestartPipelinedRegionFailover
        Strategy``); disconnected regions keep running."""
        from flink_tpu_torch.cluster.failover import region_of

        try:
            region = region_of(plan, failed_uid)
        except KeyError:
            region = {v.uid for v in plan.vertices}
        latest = self.latest_restore()
        if latest is not None:
            # a worker dying MID-RESCALE restarts against a checkpoint the
            # previous parallelism wrote (storage outlives the redeploy):
            # redistribute it — keyed state AND persisted in-flight
            # channel state — instead of restoring positionally into the
            # wrong subtask count (the idempotent-re-trigger contract)
            from flink_tpu_torch.cluster.adaptive import maybe_rescale_restore
            latest = maybe_rescale_restore(latest, plan)
        all_uids = {v.uid for v in plan.vertices}
        if region == all_uids:
            self.cancel()
            for t in self._tasks:
                t.join()
            self._deploy(plan, latest)
            return
        # pin uids: the region sub-plan re-runs topo indexing, and
        # position-derived uids would shift — snapshots key on them
        for v in plan.vertices:
            if not any(t.uid for t in v.chain):
                v.chain[0].uid = v.uid
        # cancel + drop only the failed region's tasks, keep the rest
        keep, dead = [], []
        for t in self._tasks:
            (dead if t.vertex_uid in region else keep).append(t)
        for t in dead:
            t.cancel()
        for t in dead:
            t.join()
        survivors = keep
        with self._lock:
            # only clear the failure we are handling: a DIFFERENT region may
            # have failed in the meantime and must get its own restart
            if self._failed is not None and \
                    self._failed.split("[", 1)[0] in region:
                self._failed = None
            self._pending = None
            self._finished = {f for f in self._finished
                              if f[0] not in region}
        region_plan = ExecutionPlan(
            [v for v in plan.vertices if v.uid in region], plan.job_name)
        self._deploy(region_plan, latest, _keep_tasks=survivors)

    def latest_restore(self) -> Optional[Dict[str, Any]]:
        """Most recent restorable snapshot: durable storage first, else the
        in-memory copy of the last completed checkpoint.  A storage read
        failure (checkpoint.load fault, transient error) degrades to the
        in-memory copy (or scratch) instead of escaping execute() — the
        restart attempt must stay inside the restart machinery."""
        if self.checkpoint_storage is not None:
            try:
                loaded = self.checkpoint_storage.load_latest()
            except Exception:  # noqa: BLE001
                loaded = None
            if loaded is not None:
                return loaded
        return getattr(self, "_latest_snapshot", None)

    def cancel(self) -> None:
        for t in self._tasks:
            t.cancel()

    # ------------------------------------------------------- introspection
    def execution_plan_view(self) -> Dict[str, Any]:
        """DAG topology for the dashboard (JobGraph REST view analog):
        vertices (id, name, parallelism) + edges (source, target,
        partitioning)."""
        plan = getattr(self, "_plan", None)
        if plan is None:
            return {"vertices": [], "edges": []}
        edges = []
        for v in plan.vertices:
            for e in v.out_edges:
                edges.append({"source": v.id, "target": e.target_id,
                              "partitioning": str(getattr(
                                  e, "partitioning", ""))})
        return {"vertices": [{"id": v.id, "name": v.name,
                              "parallelism": v.parallelism}
                             for v in plan.vertices],
                "edges": edges}

    def job_status(self) -> Dict[str, Any]:
        """REST-facing job view (jobs/<id> handler backing)."""
        tasks = getattr(self, "_tasks", [])
        by_vertex: Dict[str, List] = {}
        for t in tasks:
            by_vertex.setdefault(t.vertex_uid, []).append(t)
        plan = getattr(self, "_plan", None)
        # tasks key on v.uid (the stable operator id), not the int plan id
        names = ({v.uid: v.name for v in plan.vertices} if plan is not None
                 else {})
        vertices = []
        for uid, ts in by_vertex.items():
            total_ns = max(1, sum(t.busy_ns + t.idle_ns + t.backpressure_ns
                                  for t in ts))

            def ratios(t):
                tot = max(1, t.busy_ns + t.idle_ns + t.backpressure_ns)
                return (t.busy_ns / tot, t.idle_ns / tot,
                        t.backpressure_ns / tot)

            subtasks = []
            for t in sorted(ts, key=lambda t: t.subtask_index):
                b, i, bp = ratios(t)
                entry = {
                    "index": t.subtask_index, "state": t.state,
                    "records_in": t.records_in,
                    "records_out": t.records_out,
                    "busy_ratio": b, "idle_ratio": i,
                    "backpressure_ratio": bp}
                # channel-consuming subtasks: per-channel queue depth /
                # backpressured time + the alignment-queue gauge
                chan_fn = getattr(t, "channel_stats", None)
                if chan_fn is not None:
                    entry["channels"] = chan_fn()
                    entry["alignment_queued"] = t.alignment_queued
                    entry["alignment_queue_peak"] = t.alignment_queue_peak
                subtasks.append(entry)
            vertices.append({
                "id": uid,
                "name": names.get(uid, str(uid)),
                "parallelism": len(ts),
                "status": sorted({t.state for t in ts}),
                "records_in": sum(t.records_in for t in ts),
                "records_out": sum(t.records_out for t in ts),
                "busy_ratio": sum(t.busy_ns for t in ts) / total_ns,
                "idle_ratio": sum(t.idle_ns for t in ts) / total_ns,
                "backpressure_ratio":
                    sum(t.backpressure_ns for t in ts) / total_ns,
                "watermark": _vertex_watermark(ts),
                "subtasks": subtasks,
            })
        states = [t.state for t in tasks]
        terminal = (TaskStates.FINISHED, TaskStates.CANCELED)
        if self._failed is not None:
            job_state = "FAILED"
        elif states and all(s == TaskStates.FINISHED for s in states):
            job_state = "FINISHED"
        elif states and all(s in terminal for s in states):
            job_state = "CANCELED"
        elif states:
            job_state = "RUNNING"
        else:
            job_state = "CREATED"
        journal = self._trace_journal
        checkpoints = self.failure_manager.status()
        # top-level "completed_checkpoints" is the LIST of ids; this is the
        # lifetime count — name it distinctly so consumers can't mix them up
        checkpoints["num_completed_checkpoints"] = self.failure_manager \
            .num_completed()
        # unaligned-checkpoint accounting of the LAST completed checkpoint
        # (alignment critical path, overtaken + persisted in-flight bytes)
        checkpoints.update(self._last_alignment)
        paging = self.paging_totals()
        autoscaler = None
        if self.autoscaler_status_supplier is not None:
            try:
                autoscaler = self.autoscaler_status_supplier()
            except Exception:  # noqa: BLE001 — monitoring must not fail status
                autoscaler = None
        ha = None
        if self.ha_status_supplier is not None:
            try:
                ha = self.ha_status_supplier()
            except Exception:  # noqa: BLE001 — monitoring must not fail status
                ha = None
        return {
            **({"paging": paging} if paging is not None else {}),
            **({"queryable": self.queryable.stats()}
               if self.queryable is not None else {}),
            **({"autoscaler": autoscaler} if autoscaler is not None else {}),
            **({"ha": ha} if ha is not None else {}),
            "device_health": self.device_health_status(),
            #: per-(source, hop) latency percentiles (LatencyMarker flow)
            "latency": self.latency_tracker.panel(),
            #: span-journal rollup (full export: trace_events() / REST
            #: GET /jobs/<id>/trace)
            "trace": (journal.summary() if journal is not None
                      else {"enabled": False, "spans": 0, "dropped": 0}),
            "state": job_state,
            "vertices": vertices,
            "completed_checkpoints": list(self._completed_ids),
            "checkpoint_stats": list(self._checkpoint_stats),
            #: failed-checkpoint counters + tolerable budget (the
            #: CheckpointFailureManager view) and restart count
            "checkpoints": checkpoints,
            "failed_checkpoints": self.failure_manager.num_failed(),
            "restarts": self._restarts,
            "exception_history": list(self._exception_history),
            "failure": self._failed,
        }

    def trace_events(self) -> Dict[str, Any]:
        """Chrome trace-event export of the process span journal
        (Perfetto-loadable; REST ``GET /jobs/<id>/trace`` backing)."""
        journal = self._trace_journal
        if journal is None:
            return {"traceEvents": [], "displayTimeUnit": "ms",
                    "otherData": {"enabled": False}}
        snap = journal.snapshot()
        return {"traceEvents": tracing.to_chrome(snap, pid=0,
                                                 process_name="minicluster"),
                "displayTimeUnit": "ms",
                "otherData": {"enabled": True,
                              "dropped_spans": snap["dropped"],
                              "latency": self.latency_tracker.panel()}}

    def sink_latencies_ms(self) -> List[float]:
        out: List[float] = []
        for t in getattr(self, "_tasks", []):
            op = t.operator
            ops = getattr(op, "operators", [op])
            for member in ops:
                out.extend(getattr(member, "latencies_ms", []))
        return out

    def savepoint(self) -> Optional[int]:
        """User-triggered checkpoint (savepoint analog): returns its id once
        completed, or None if it could not complete.  Savepoint barriers
        never escalate to unaligned — the snapshot stays rescalable and
        rewritable even without channel-state redistribution."""
        return self._triggered_checkpoint(savepoint=True)

    def checkpoint(self, timeout_s: Optional[float] = None) -> Optional[int]:
        """A fresh consistent cut of the RUNNING job — the rescale-under-
        fire primitive: returns the id of the next checkpoint to COMPLETE
        after this call (triggering one itself whenever no periodic
        attempt holds the slot).  Unlike :meth:`savepoint` the cut's
        barriers MAY escalate to unaligned under backpressure, so it
        completes in bounded time exactly when the job is drowning, and
        its persisted in-flight channel state redistributes by key on
        restore at a different parallelism
        (``state/redistribute.redistribute_channel_state``).  Adopting
        the next completed id (rather than insisting on its own trigger)
        matters on jobs with a short checkpoint interval: every completed
        checkpoint is an equally valid cut, and racing the periodic
        trigger loop for the pending slot could starve past any budget.
        Returns None when no cut is possible (sources finished)."""
        budget = (timeout_s if timeout_s is not None
                  else self.checkpoint_timeout_s)
        deadline = time.monotonic() + budget
        with self._lock:
            baseline = max(self._completed_ids, default=0)
        while time.monotonic() < deadline:
            with self._lock:
                newer = [c for c in self._completed_ids if c > baseline]
                if newer:
                    return max(newer)
                if self._failed is not None:
                    return None
            _cid, reason = self._trigger_checkpoint()
            if reason == "declined":
                return None    # permanently impossible (sources done)
            time.sleep(0.005)
        return None

    def _triggered_checkpoint(self, savepoint: bool,
                              timeout_s: Optional[float] = None
                              ) -> Optional[int]:
        budget = (timeout_s if timeout_s is not None
                  else self.checkpoint_timeout_s)
        cid = None
        deadline0 = time.monotonic() + budget
        while cid is None and time.monotonic() < deadline0:
            cid, reason = self._trigger_checkpoint(savepoint=savepoint)
            if cid is None:
                if reason == "declined":
                    return None    # permanently impossible (sources done)
                # a periodic checkpoint is in flight: wait for its slot
                time.sleep(0.005)
        if cid is None:
            return None
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            with self._lock:
                if cid in self._completed_ids:
                    return cid
                if self._failed is not None:
                    return None
            time.sleep(0.005)
        return None

    def stop_with_savepoint(self) -> Optional[int]:
        """``flink stop`` analog: PAUSE the sources, take a savepoint, then
        cancel — pausing first means no record is processed after the
        savepoint's barrier, so the returned id restores a successor run
        exactly where this one stopped (the reference suspends sources at
        the stop barrier for the same reason).  None if no savepoint could
        complete; sources resume in that case and the job keeps running."""
        for t in self._source_tasks:
            t._paused.set()
        sp = self.savepoint()
        if sp is None:
            for t in self._source_tasks:
                t._paused.clear()
            return None
        self.cancel()
        return sp

"""Hierarchical metric groups + registry (port of ``flink_tpu/metrics/groups.py``).

Analog of ``runtime/metrics/groups/`` + ``MetricRegistryImpl.java:67``: every
metric lives in a scope tree (jobmanager|taskmanager → job → task → operator,
plus free-form user groups); the registry fans registrations out to reporters
and owns the scope-string formatting (``runtime/metrics/scope/``).

System metric names follow the reference's ``MetricNames.java``
(numRecordsIn/Out, numLateRecordsDropped, currentWatermark, busyTimeMsPerSecond)
so dashboards translate one-to-one.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from flink_tpu_torch.metrics.core import (Counter, Gauge, Histogram, Meter, Metric,
                                    SettableGauge)

# MetricNames.java analogs
NUM_RECORDS_IN = "numRecordsIn"
NUM_RECORDS_OUT = "numRecordsOut"
NUM_LATE_RECORDS_DROPPED = "numLateRecordsDropped"
CURRENT_WATERMARK = "currentInputWatermark"
BUSY_TIME = "busyTimeMsPerSecond"
NUM_RESTARTS = "numRestarts"
CHECKPOINT_DURATION = "lastCheckpointDuration"
CHECKPOINT_SIZE = "lastCheckpointSize"
NUM_COMPLETED_CHECKPOINTS = "numberOfCompletedCheckpoints"
NUM_FAILED_CHECKPOINTS = "numberOfFailedCheckpoints"
# device-state paging occupancy (state/paging.py; RocksDB block-cache
# hit/miss counter analogs for the HBM pane-ring cache)
PAGING_RESIDENT_KEYS = "paging.resident_keys"
PAGING_SPILLED_KEYS = "paging.spilled_keys"
PAGING_EVICTIONS = "paging.evictions"
PAGING_PROMOTIONS = "paging.promotions"
# device-lane health (runtime/device_health.py): watchdog + quarantine/
# heal cycle of the process's accelerator tier
DEVICE_HEALTH_STATE = "device_health.state"          # 0 healthy, 1 quarantined
DEVICE_HEALTH_QUARANTINES = "device_health.quarantines"
DEVICE_HEALTH_HEALS = "device_health.heals"
DEVICE_HEALTH_WATCHDOG_TIMEOUTS = "device_health.watchdog_timeouts"
DEVICE_HEALTH_NEAR_MISSES = "device_health.near_misses"
DEVICE_HEALTH_TRANSIENT_RETRIES = "device_health.transient_retries"
DEVICE_HEALTH_OOM_PAGEOUTS = "device_health.oom_pageouts"
DEVICE_HEALTH_DEGRADED_OPERATORS = "device_health.degraded_operators"
# checkpoint alignment / unaligned-checkpoint accounting (the reference's
# checkpointAlignmentTime + lastCheckpointPersistedData analogs)
CHECKPOINT_ALIGNMENT_TIME = "lastCheckpointAlignmentTime"
CHECKPOINT_OVERTAKEN_BYTES = "lastCheckpointOvertakenBytes"
CHECKPOINT_PERSISTED_INFLIGHT = "lastCheckpointPersistedInFlightBytes"
NUM_UNALIGNED_CHECKPOINTS = "numberOfUnalignedCheckpoints"
# channel backpressure (backPressuredTimeMsPerSecond family, folded to
# job scope: totals + the deepest input queue + alignment buffering)
BACKPRESSURED_TIME_MS = "backpressure.total_backpressured_ms"
BACKPRESSURE_MAX_QUEUE_DEPTH = "backpressure.max_queue_depth"
BACKPRESSURE_ALIGNMENT_QUEUED = "backpressure.alignment_queued_elements"
# queryable serving tier (queryable/service.py): lookup volume + latency
# percentiles and the read replicas' staleness (checkpoints behind the
# stream head, and for how long)
QUERYABLE_LOOKUPS = "queryable.lookups_total"
QUERYABLE_QPS = "queryable.lookups_per_sec"
QUERYABLE_P50 = "queryable.lookup_p50_ms"
QUERYABLE_P99 = "queryable.lookup_p99_ms"
QUERYABLE_REPLICA_LAG_CHECKPOINTS = "queryable.replica_lag_checkpoints"
QUERYABLE_REPLICA_LAG_MS = "queryable.replica_lag_ms"
# server-side SERVICE time (lookup + serialization, measured in the TCP
# handler) — the honest serve latency next to the client-side ring, whose
# p99 on a GIL-loaded box measures the box, not the server
QUERYABLE_SERVE_P50 = "queryable.serve_p50_ms"
QUERYABLE_SERVE_P99 = "queryable.serve_p99_ms"
QUERYABLE_CACHE_HIT_RATE = "queryable.cache_hit_rate"
# reactive autoscaler (cluster/adaptive.ReactiveAutoscaler): the rescale
# lifecycle's health — current vs target parallelism, how often the job
# rescaled, how long the last rescale window was, and how many rescales
# rolled back / re-triggered inside the window
AUTOSCALER_CURRENT_PARALLELISM = "autoscaler.current_parallelism"
AUTOSCALER_TARGET_PARALLELISM = "autoscaler.target_parallelism"
AUTOSCALER_RESCALES = "autoscaler.rescales_total"
AUTOSCALER_ROLLBACKS = "autoscaler.rollbacks_total"
AUTOSCALER_RETRIGGERS = "autoscaler.retriggers_total"
AUTOSCALER_LAST_RESCALE_MS = "autoscaler.last_rescale_duration_ms"
AUTOSCALER_COOLDOWN_REMAINING_MS = "autoscaler.cooldown_remaining_ms"
# coordinator high availability (runtime/ha.py): the leader's fencing
# epoch, demotion state, and how much stale-epoch traffic was rejected
HA_LEADER_EPOCH = "ha.leader_epoch"
HA_DEMOTED = "ha.demoted"                           # 0 leading, 1 demoted
HA_FENCED_COMPLETIONS = "ha.fenced_completions"
HA_FENCED_WORKER_MSGS = "ha.fenced_worker_msgs"


class MetricGroup:
    """One node of the scope tree (``AbstractMetricGroup`` analog)."""

    def __init__(self, registry: "MetricRegistry", scope: Tuple[str, ...],
                 parent: Optional["MetricGroup"] = None):
        self._registry = registry
        self._scope = scope
        self._parent = parent
        self._metrics: Dict[str, Metric] = {}
        self._groups: Dict[str, "MetricGroup"] = {}

    # -- structure -----------------------------------------------------------
    def add_group(self, name: str) -> "MetricGroup":
        g = self._groups.get(name)
        if g is None:
            g = MetricGroup(self._registry, self._scope + (str(name),), self)
            self._groups[name] = g
        return g

    @property
    def scope(self) -> Tuple[str, ...]:
        return self._scope

    def metric_identifier(self, name: str, delimiter: str = ".") -> str:
        return delimiter.join(self._scope + (name,))

    # -- registration --------------------------------------------------------
    def _register(self, name: str, metric: Metric) -> Metric:
        existing = self._metrics.get(name)
        if existing is not None:
            return existing
        self._metrics[name] = metric
        self._registry.register(metric, name, self)
        return metric

    def counter(self, name: str) -> Counter:
        return self._register(name, Counter())

    def gauge(self, name: str, supplier: Optional[Callable[[], Any]] = None):
        if supplier is None:
            return self._register(name, SettableGauge())
        return self._register(name, Gauge(supplier))

    def meter(self, name: str, **kw) -> Meter:
        return self._register(name, Meter(**kw))

    def histogram(self, name: str, **kw) -> Histogram:
        return self._register(name, Histogram(**kw))

    # -- introspection -------------------------------------------------------
    def metrics(self) -> Dict[str, Metric]:
        return dict(self._metrics)

    def all_metrics(self) -> Dict[str, Metric]:
        """Fully-qualified identifier -> metric, for this subtree."""
        out = {self.metric_identifier(n): m for n, m in self._metrics.items()}
        for g in self._groups.values():
            out.update(g.all_metrics())
        return out


class MetricRegistry:
    """Fan-out hub: registrations notify every reporter
    (``MetricRegistryImpl`` analog; reporting runs on a timer thread when an
    interval is configured, like the reference's reporter scheduler)."""

    def __init__(self, reporters: Optional[List] = None,
                 report_interval_s: float = 0.0):
        self.reporters = list(reporters or [])
        self._roots: List[MetricGroup] = []
        self._lock = threading.Lock()
        self._timer: Optional[threading.Timer] = None
        self._stopped = False
        self._interval = report_interval_s
        if report_interval_s > 0 and self.reporters:
            self._schedule()

    # -- scope roots ---------------------------------------------------------
    def task_manager_group(self, tm_id: str = "tm-0") -> MetricGroup:
        g = MetricGroup(self, ("taskmanager", tm_id))
        self._roots.append(g)
        return g

    def job_manager_group(self) -> MetricGroup:
        g = MetricGroup(self, ("jobmanager",))
        self._roots.append(g)
        return g

    def register(self, metric: Metric, name: str, group: MetricGroup) -> None:
        with self._lock:
            for r in self.reporters:
                r.notify_of_added_metric(metric, name, group)

    def all_metrics(self) -> Dict[str, Metric]:
        out: Dict[str, Metric] = {}
        for g in self._roots:
            out.update(g.all_metrics())
        return out

    # -- periodic reporting --------------------------------------------------
    def _schedule(self) -> None:
        with self._lock:
            if self._stopped:
                return
            self._timer = threading.Timer(self._interval, self._tick)
            self._timer.daemon = True
            self._timer.start()

    def _tick(self) -> None:
        self.report_now()
        self._schedule()

    def report_now(self) -> None:
        for r in self.reporters:
            r.report(self.all_metrics())

    def close(self) -> None:
        # _stopped gates _schedule so a _tick racing close() cannot re-arm
        # the timer after it was cancelled
        with self._lock:
            self._stopped = True
            if self._timer is not None:
                self._timer.cancel()
        for r in self.reporters:
            close = getattr(r, "close", None)
            if close:
                close()


def task_metric_group(registry: MetricRegistry, job_name: str,
                      task_name: str, subtask_index: int) -> MetricGroup:
    """taskmanager.<tm>.<job>.<task>.<subtask> — the scope format of
    ``TaskMetricGroup`` (``runtime/metrics/scope/ScopeFormats``)."""
    return (registry.task_manager_group()
            .add_group(job_name).add_group(task_name)
            .add_group(str(subtask_index)))


class OperatorIOMetrics:
    """numRecordsIn/Out + rates for one operator (``OperatorIOMetricGroup``)."""

    def __init__(self, group: MetricGroup):
        self.group = group
        self.records_in = group.counter(NUM_RECORDS_IN)
        self.records_out = group.counter(NUM_RECORDS_OUT)
        self.late_dropped = group.counter(NUM_LATE_RECORDS_DROPPED)
        self.watermark = group.gauge(CURRENT_WATERMARK)


def paging_metrics(group: MetricGroup,
                   stats_supplier: Callable[[], Optional[Dict[str, int]]]
                   ) -> MetricGroup:
    """Register the device-paging occupancy gauges on a (job-scope) group:
    ``paging.resident_keys`` / ``paging.spilled_keys`` / ``paging.evictions``
    / ``paging.promotions``.  ``stats_supplier`` returns the aggregated
    :meth:`WindowAggOperator.paging_stats` dict (or None/empty -> 0s)."""
    def _read(key: str) -> Callable[[], int]:
        return lambda: int((stats_supplier() or {}).get(key, 0))

    for name, key in ((PAGING_RESIDENT_KEYS, "resident_keys"),
                      (PAGING_SPILLED_KEYS, "spilled_keys"),
                      (PAGING_EVICTIONS, "evictions"),
                      (PAGING_PROMOTIONS, "promotions")):
        group.gauge(name, _read(key))
    return group


def device_health_metrics(group: MetricGroup,
                          status_supplier: Callable[[], Dict[str, Any]]
                          ) -> MetricGroup:
    """Register the device-lane health gauges on a (job-scope) group:
    state (0 healthy / 1 quarantined), quarantine + heal counters,
    watchdog timeouts/near-misses, transient retries, OOM page-outs, and
    the count of operators currently running degraded.  ``status_supplier``
    returns ``job_status()["device_health"]``-shaped dicts."""
    def _read(key: str, default: int = 0) -> Callable[[], int]:
        return lambda: int((status_supplier() or {}).get(key, default))

    group.gauge(DEVICE_HEALTH_STATE,
                lambda: int((status_supplier() or {}).get("state")
                            == "quarantined"))
    for name, key in ((DEVICE_HEALTH_QUARANTINES, "quarantines"),
                      (DEVICE_HEALTH_HEALS, "heals"),
                      (DEVICE_HEALTH_WATCHDOG_TIMEOUTS, "watchdog_timeouts"),
                      (DEVICE_HEALTH_NEAR_MISSES, "near_misses"),
                      (DEVICE_HEALTH_TRANSIENT_RETRIES, "transient_retries"),
                      (DEVICE_HEALTH_OOM_PAGEOUTS, "oom_pageouts"),
                      (DEVICE_HEALTH_DEGRADED_OPERATORS,
                       "degraded_operators")):
        group.gauge(name, _read(key))
    return group


def backpressure_metrics(group: MetricGroup,
                         totals_supplier: Callable[[], Dict[str, Any]]
                         ) -> MetricGroup:
    """Register the channel-backpressure gauges on a (job-scope) group:
    total producer credit-wait ms, deepest input queue, and elements
    buffered by barrier alignment.  ``totals_supplier`` returns
    ``MiniCluster.backpressure_totals()``-shaped dicts."""
    def _read(key: str) -> Callable[[], Any]:
        return lambda: (totals_supplier() or {}).get(key, 0)

    for name, key in ((BACKPRESSURED_TIME_MS, "total_backpressured_ms"),
                      (BACKPRESSURE_MAX_QUEUE_DEPTH, "max_queue_depth"),
                      (BACKPRESSURE_ALIGNMENT_QUEUED,
                       "alignment_queued_elements")):
        group.gauge(name, _read(key))
    return group


def queryable_metrics(group: MetricGroup,
                      stats_supplier: Callable[[], Optional[Dict[str, Any]]]
                      ) -> MetricGroup:
    """Register the queryable serving tier's gauges on a (job-scope)
    group: lookup volume/qps, p50/p99 lookup latency, and replica
    staleness.  ``stats_supplier`` returns
    :meth:`QueryableStateService.stats` dicts (or None -> 0s)."""
    def _read(key: str, default=0) -> Callable[[], Any]:
        def read():
            v = (stats_supplier() or {}).get(key)
            return default if v is None else v
        return read

    for name, key in ((QUERYABLE_LOOKUPS, "lookups_total"),
                      (QUERYABLE_QPS, "lookups_per_sec"),
                      (QUERYABLE_P50, "lookup_p50_ms"),
                      (QUERYABLE_P99, "lookup_p99_ms"),
                      (QUERYABLE_SERVE_P50, "serve_p50_ms"),
                      (QUERYABLE_SERVE_P99, "serve_p99_ms"),
                      (QUERYABLE_CACHE_HIT_RATE, "cache_hit_rate"),
                      (QUERYABLE_REPLICA_LAG_CHECKPOINTS,
                       "replica_lag_checkpoints"),
                      (QUERYABLE_REPLICA_LAG_MS, "replica_lag_ms")):
        group.gauge(name, _read(key))
    return group


def autoscaler_metrics(group: MetricGroup,
                       status_supplier: Callable[[], Optional[Dict[str, Any]]]
                       ) -> MetricGroup:
    """Register the reactive autoscaler's gauges on a (job-scope) group:
    current/target parallelism, rescale/rollback/re-trigger counters, the
    last rescale window's duration, and the cooldown remaining.
    ``status_supplier`` returns :meth:`ReactiveAutoscaler.status` dicts
    (or None -> 0s)."""
    def _read(key: str, default=0) -> Callable[[], Any]:
        def read():
            v = (status_supplier() or {}).get(key)
            return default if v is None else v
        return read

    for name, key in ((AUTOSCALER_CURRENT_PARALLELISM,
                       "current_parallelism"),
                      (AUTOSCALER_TARGET_PARALLELISM, "target_parallelism"),
                      (AUTOSCALER_RESCALES, "rescales"),
                      (AUTOSCALER_ROLLBACKS, "rollbacks"),
                      (AUTOSCALER_RETRIGGERS, "retriggers"),
                      (AUTOSCALER_LAST_RESCALE_MS,
                       "last_rescale_duration_ms"),
                      (AUTOSCALER_COOLDOWN_REMAINING_MS,
                       "cooldown_remaining_ms")):
        group.gauge(name, _read(key))
    return group


def ha_metrics(group: MetricGroup,
               status_supplier: Callable[[], Optional[Dict[str, Any]]]
               ) -> MetricGroup:
    """Register the coordinator-HA gauges on a (job-scope) group: the
    leader epoch every control message is fenced by, whether this
    coordinator has been demoted (lease lost), and the counts of
    stale-epoch completions / worker messages it rejected.
    ``status_supplier`` returns ``ha_status()``-shaped dicts (or None ->
    0s, e.g. HA disabled)."""
    def _read(key: str, default=0) -> Callable[[], Any]:
        def read():
            v = (status_supplier() or {}).get(key)
            return default if v is None else v
        return read

    group.gauge(HA_DEMOTED,
                lambda: int(bool((status_supplier() or {}).get("demoted"))))
    for name, key in ((HA_LEADER_EPOCH, "leader_epoch"),
                      (HA_FENCED_COMPLETIONS, "fenced_completions"),
                      (HA_FENCED_WORKER_MSGS, "fenced_worker_msgs")):
        group.gauge(name, _read(key))
    return group


def checkpoint_alignment_metrics(group: MetricGroup,
                                 stats_supplier: Callable[[], Dict[str, Any]]
                                 ) -> MetricGroup:
    """Register the unaligned-checkpoint accounting gauges on a (job-scope)
    group: alignment duration, overtaken bytes and persisted in-flight
    bytes of the last completed checkpoint, plus the lifetime count of
    checkpoints that escalated to unaligned."""
    def _read(key: str) -> Callable[[], Any]:
        return lambda: (stats_supplier() or {}).get(key, 0)

    for name, key in (
            (CHECKPOINT_ALIGNMENT_TIME, "last_alignment_duration_ms"),
            (CHECKPOINT_OVERTAKEN_BYTES, "last_overtaken_bytes"),
            (CHECKPOINT_PERSISTED_INFLIGHT,
             "last_persisted_inflight_bytes"),
            (NUM_UNALIGNED_CHECKPOINTS, "unaligned_checkpoints")):
        group.gauge(name, _read(key))
    return group


def job_checkpoint_metrics(group: MetricGroup, failure_manager,
                           restarts_supplier: Callable[[], int]) -> MetricGroup:
    """Register a CheckpointFailureManager's lifetime counters + the restart
    count on a job-scope group (``CheckpointStatsTracker`` /
    ``numRestarts`` analogs) so reporters export them; returns the group."""
    group._register(NUM_COMPLETED_CHECKPOINTS,
                    failure_manager.completed_counter)
    group._register(NUM_FAILED_CHECKPOINTS, failure_manager.failed_counter)
    group.gauge(NUM_RESTARTS, restarts_supplier)
    return group

"""Adaptive (reactive) scheduling: rescale the job — drained OR under fire
(port of ``flink_tpu/cluster/adaptive.py``, host Python as JAX's).

Analog of ``runtime/scheduler/adaptive/AdaptiveScheduler.java:146``
(FLIP-160): a state machine — Created → WaitingForResources → Executing →
Restarting → Finished/Failed — that sizes the job to whatever slots exist.
``declare_slots(n)`` (the reactive-mode resource declaration) triggers a
rescale: take a savepoint, cancel, re-split every keyed vertex's state to
the new parallelism through the key-group redistribution path, and redeploy.

:class:`ReactiveAutoscaler` closes the loop for the
BACKPRESSURED case: driven by the job's own backpressure / queue-depth /
alignment gauges (and the per-(source, hop) latency p99s), it rescales
via an **unaligned checkpoint of the running job** — no drain — with the
persisted in-flight channel state redistributed by record key
(``state/redistribute.redistribute_channel_state``, the FLIP-76
follow-on).  The rescale lifecycle is a supervised failure domain: a
bounded deadline with rollback to the pre-rescale checkpoint, idempotent
re-trigger after a kill inside the window (chaos point
``rescale.redistribute``; ``testing.chaos.KillDuringRescale``), and a
``rescale`` trace span covering trigger→checkpoint→redistribute→redeploy→
first-output.

Rescale contract: sources must have STABLE splits (split count independent
of job parallelism — files, log partitions); their offsets carry over
unchanged.  Keyed vertex state is merged across old subtasks and re-split
by key-group range (``StateAssignmentOperation.reDistributeKeyedStates``).

Time discipline: every cooldown / deadline / elapsed
DECISION in this module reads the injectable ``utils/clock.py`` seam
through :class:`~flink_tpu_torch.utils.clock.MonotoneElapsed`, so a chaos
``ClockSkew`` backward step can neither un-expire a rescale deadline nor
turn the autoscaler's cooldown into a rescale storm; loop pacing uses
``clock.sleep`` (a raw passthrough — scheduling, not a decision).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.core import keygroups

from flink_tpu_torch.cluster.failover import (FixedDelayRestartStrategy,
                                              RestartStrategy)
from flink_tpu_torch.cluster.minicluster import JobResult, MiniCluster
from flink_tpu_torch.graph.stream_graph import ExecutionPlan
from flink_tpu_torch.observability import tracing
from flink_tpu_torch.state.redistribute import (redistribute_channel_state,
                                                snapshot_operator_class,
                                                split_keyed_snapshot)
from flink_tpu_torch.state_processor.savepoint import (_is_keyed,
                                                       _merged_operator_snapshot)
from flink_tpu_torch.testing import chaos
from flink_tpu_torch.utils import clock
from flink_tpu_torch.utils.clock import MonotoneElapsed


class SchedulerStates:
    CREATED = "Created"
    WAITING_FOR_RESOURCES = "WaitingForResources"
    EXECUTING = "Executing"
    RESTARTING = "Restarting"
    FINISHED = "Finished"
    FAILED = "Failed"
    CANCELED = "Canceled"


def _split_member(member: Dict[str, Any], max_parallelism: int,
                  n: int) -> List[Dict[str, Any]]:
    # operators with their own rescale split/merge pair (window aggregate,
    # session windows, CEP per-key state, two-phase-commit sinks) dispatch
    # through the ONE kind table the savepoint merge also uses
    cls = snapshot_operator_class(member)
    if cls is not None:
        return cls.split_snapshot(member, max_parallelism, n)
    if _is_keyed(member):
        fields = sorted({k for k in member
                         if k.startswith("state.") or k == "leaves"})
        return split_keyed_snapshot(member, fields, max_parallelism, n)
    # stateless / non-keyed member: subtask 0 keeps it, others start fresh
    return [member] + [{} for _ in range(n - 1)]


def _is_collect_sink_member(m: Any) -> bool:
    return isinstance(m, dict) and set(m) == {"batches"} \
        and isinstance(m["batches"], list)


def _union_shared_sink_members(ops: List[Dict[str, Any]], key_column: str,
                               max_parallelism: int) -> None:
    """Exactly-once merge for SHARED collect-sink chain members, in place.

    One CollectSink instance is shared by every subtask, so each
    subtask's snapshot is the shared row list AS OF ITS OWN barrier —
    under an unaligned cut those moments differ, and keeping any single
    copy is inconsistent: a row fired by subtask i between copy j's
    snapshot and i's own is present in i's copy and EVICTED from i's
    pane state, so dropping i's copy loses it forever.  The consistent
    composition is per-key owner filtering: subtask i's copy contributes
    exactly the rows of keys i OWNS (i's own fires run on i's thread, so
    they are in i's copy iff they preceded i's snapshot iff their pane
    state is gone) — union those slices and park the result on subtask
    0's member (the non-keyed merge keeps subtask 0), emptying the rest.
    Members without the key column fall back untouched."""
    P = len(ops)
    member_keys = sorted(k for k in ops[0]
                         if k.startswith("op") and k[2:].isdigit()
                         and all(_is_collect_sink_member(o.get(k))
                                 for o in ops if isinstance(o, dict)))
    for mk in member_keys:
        if any(key_column not in cols for o in ops
               for cols, _ts in o[mk]["batches"]):
            continue                # unkeyed rows: keep old behavior
        kept = []
        for i, o in enumerate(ops):
            for cols, ts in o[mk]["batches"]:
                keys = np.asarray(cols[key_column])
                mine = keygroups.route_raw_keys(
                    keys, P, max_parallelism) == i
                if mine.any():
                    kept.append((
                        {c: np.asarray(v)[mine] for c, v in cols.items()},
                        None if ts is None else np.asarray(ts)[mine]))
        for i, o in enumerate(ops):
            o[mk] = {"batches": kept} if i == 0 else {}


def _channel_sections(old_subs: List[Any]) -> List[Any]:
    return [(sub or {}).get("channel_state") if isinstance(sub, dict)
            else None for sub in old_subs]


def _has_inflight(sections: List[Any]) -> bool:
    for cs in sections:
        els = cs.get("elements", []) if isinstance(cs, dict) else cs
        if els:
            return True
    return False


def rescale_snapshot(snapshot: Dict[str, Any], plan: ExecutionPlan,
                     new_counts: Dict[str, int]) -> Dict[str, Any]:
    """A MiniCluster checkpoint taken at one parallelism -> restorable at
    another (the StateAssignmentOperation analog), INCLUDING unaligned
    checkpoints: persisted in-flight channel state (v2 sections) is
    decoded per element and re-routed by the record's own key into the
    new key-group ranges (``redistribute_channel_state`` — the FLIP-76
    follow-on, ``reDistributeKeyedStates`` for in-flight data); non-keyed
    and broadcast in-flight elements replay on their downstream's subtask
    0.  Legacy v1 sections with non-empty elements still fail loudly
    (``ChannelStateRescaleError``) — they carry no routing metadata.

    Fires the ``rescale.redistribute`` chaos point once per genuine
    rescale, BEFORE any state is transformed: a schedule killing/stalling
    here lands inside the rescale window with the pre-rescale checkpoint
    still intact, so the lifecycle's re-trigger is idempotent."""
    out: Dict[str, Any] = {}
    by_uid = {v.uid: v for v in plan.vertices}
    rescaled = sorted(
        uid for uid, entry in snapshot.items()
        if not uid.startswith("__") and uid in by_uid
        and not by_uid[uid].is_source and new_counts.get(uid) is not None
        and isinstance(entry, dict)
        and len(entry.get("subtasks", [])) != new_counts[uid])
    if rescaled:
        # the chaos seam of the rescale window (KillDuringRescale prey)
        chaos.fire("rescale.redistribute", uids=rescaled)
    producers: Dict[str, List[str]] = {}
    for u in plan.vertices:
        for e in u.out_edges:
            producers.setdefault(plan.by_id[e.target_id].uid,
                                 []).append(u.uid)

    def upstream_changed(uid: str) -> bool:
        """Did this vertex's INPUT topology change — i.e. does any
        producer's subtask count differ from the snapshot's?  A vertex
        whose own count AND whose producers' counts are unchanged keeps
        its channel state positionally (physical indices stay valid)."""
        for pu in producers.get(uid, []):
            pe = snapshot.get(pu)
            n_old = (len(pe.get("subtasks", []))
                     if isinstance(pe, dict) else None)
            n_want = new_counts.get(pu)
            if n_old is not None and n_want is not None \
                    and n_old != n_want:
                return True
        return False

    for uid, entry in snapshot.items():
        if uid.startswith("__"):
            out[uid] = entry
            continue
        v = by_uid.get(uid)
        n_new = new_counts.get(uid)
        if v is None or n_new is None:
            out[uid] = entry
            continue
        old_subs = entry.get("subtasks", []) if isinstance(entry, dict) else []
        if v.is_source:
            if len(old_subs) != n_new:
                raise ValueError(
                    f"rescale: source {uid!r} split count changed "
                    f"({len(old_subs)} -> {n_new}); adaptive rescale needs "
                    f"stable-split sources (files / log partitions)")
            out[uid] = entry
            continue
        sections = _channel_sections(old_subs)
        if len(old_subs) == n_new:
            if rescaled and _has_inflight(sections) \
                    and upstream_changed(uid):
                # the vertex keeps its parallelism but its UPSTREAM
                # rescales: physical channel indices die with the old
                # input topology — re-route its in-flight elements too
                # (keyed elements land back on the same subtask: the
                # key-group assignment is the same function).  A vertex
                # whose inputs are untouched keeps positional replay.
                new_secs = redistribute_channel_state(sections, n_new)
                entry = dict(entry)
                entry["subtasks"] = [
                    dict(sub or {}, channel_state=new_secs[i])
                    for i, sub in enumerate(entry["subtasks"])]
            out[uid] = entry
            continue
        new_secs = (redistribute_channel_state(sections, n_new)
                    if _has_inflight(sections) else None)
        # shared collect-sink members: per-key owner-filtered union BEFORE
        # the merge (keep-subtask-0 would drop rows other owners already
        # evicted from their pane state — see _union_shared_sink_members)
        kc = kmaxp = None
        for u in plan.vertices:
            for e in u.out_edges:
                if plan.by_id[e.target_id].uid == uid \
                        and e.partitioning == "hash" and e.key_column:
                    kc, kmaxp = e.key_column, u.max_parallelism
        if kc is not None and old_subs \
                and all(isinstance(s, dict) and isinstance(
                    s.get("operator"), dict) for s in old_subs):
            ops = [dict(s["operator"]) for s in old_subs]
            _union_shared_sink_members(ops, kc, kmaxp)
            entry = dict(entry)
            entry["subtasks"] = [dict(s, operator=o)
                                 for s, o in zip(old_subs, ops)]
        # strict: a keyed member that cannot merge must FAIL the rescale
        # (the lifecycle retries / rolls back), never silently redeploy
        # with only subtask 0's share of the state
        merged = _merged_operator_snapshot(entry, strict=True)
        inner = merged.get("operator", merged)
        maxp = v.max_parallelism
        member_keys = [k for k in inner
                       if k.startswith("op") and k[2:].isdigit()]
        parts: List[Dict[str, Any]]
        if member_keys:
            split_members = {mk: _split_member(inner[mk], maxp, n_new)
                             for mk in member_keys}
            passthrough = {k: v2 for k, v2 in inner.items()
                           if k not in member_keys}
            parts = [dict(passthrough,
                          **{mk: split_members[mk][i] for mk in member_keys})
                     for i in range(n_new)]
        else:
            parts = _split_member(inner, maxp, n_new)
        wrapped = []
        for p in parts:
            if isinstance(merged, dict) and "operator" in merged:
                w = {k: v2 for k, v2 in merged.items() if k != "operator"}
                w["operator"] = p
                wrapped.append(w)
            else:
                wrapped.append({"operator": p, "valve": None}
                               if "operator" not in p else p)
        # subtask snapshots are {"operator": ..., "valve": ...} shaped
        subs = [w if "operator" in w else {"operator": w} for w in wrapped]
        if new_secs is not None:
            for i, sub in enumerate(subs):
                sub["channel_state"] = new_secs[i]
        out[uid] = {"subtasks": subs}
    return out


def counts_for_plan(plan: ExecutionPlan) -> Dict[str, int]:
    """Per-vertex subtask count the deploying cluster will use — THE
    deploy-side implementation (``distributed.subtask_counts_of``), not a
    mirror of it: a rescale split to any other count would restore whole
    key-group ranges into subtasks that never deploy."""
    from flink_tpu_torch.cluster.distributed import subtask_counts_of
    return subtask_counts_of(plan)[0]


def maybe_rescale_restore(restore: Optional[Dict[str, Any]],
                          plan: ExecutionPlan) -> Optional[Dict[str, Any]]:
    """Restore-time guard shared by MiniCluster / ProcessCluster deploys:
    when a snapshot's recorded subtask counts differ from what ``plan``
    will deploy, redistribute it (keyed state AND persisted in-flight
    channel state) through :func:`rescale_snapshot` instead of restoring
    positionally — a positional restore at the wrong parallelism silently
    drops/misroutes whole key-group ranges.  Snapshots matching the plan
    (and non-subtask layouts) pass through untouched."""
    if not isinstance(restore, dict):
        return restore
    counts = None
    mismatch = False
    for v in plan.vertices:
        entry = restore.get(v.uid)
        if not isinstance(entry, dict) or "subtasks" not in entry:
            continue
        if counts is None:
            counts = counts_for_plan(plan)
        if len(entry["subtasks"]) != counts[v.uid]:
            mismatch = True
            break
    if not mismatch:
        return restore
    return rescale_snapshot(restore, plan, counts)


class AdaptiveScheduler:
    """Reactive scheduler over the MiniCluster."""

    def __init__(self, plan_factory: Callable[[int], ExecutionPlan],
                 checkpoint_storage=None, checkpoint_interval_ms: int = 20,
                 restart_strategy: Optional[RestartStrategy] = None,
                 min_slots: int = 1):
        self.plan_factory = plan_factory
        self.checkpoint_storage = checkpoint_storage
        self.checkpoint_interval_ms = checkpoint_interval_ms
        self.restart_strategy = restart_strategy or FixedDelayRestartStrategy(2)
        self.min_slots = min_slots
        self.state = SchedulerStates.CREATED
        self._slots = 0
        self._desired_slots = 0
        self._cluster: Optional[MiniCluster] = None
        self._result: Optional[JobResult] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.rescales = 0
        self.error: Optional[str] = None

    # -- resources (reactive declaration) ------------------------------------
    def declare_slots(self, n: int) -> None:
        """Reactive mode: the cluster now has ``n`` slots; the scheduler
        rescales the job to use all of them (FLIP-160)."""
        with self._lock:
            self._desired_slots = n

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "AdaptiveScheduler":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="adaptive-scheduler")
        self._thread.start()
        return self

    def cancel(self) -> None:
        self._stop.set()
        if self._cluster is not None:
            self._cluster.cancel()

    def join(self, timeout_s: float = 120.0) -> Optional[JobResult]:
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
        return self._result

    # -- state machine --------------------------------------------------------
    def _run(self) -> None:
        try:
            self._run_inner()
        except Exception as e:  # noqa: BLE001 — scheduler thread must not die silently
            self.error = f"{type(e).__name__}: {e}"
            self.state = SchedulerStates.FAILED

    def _run_inner(self) -> None:
        self.state = SchedulerStates.WAITING_FOR_RESOURCES
        while not self._stop.is_set():
            with self._lock:
                desired = self._desired_slots
            if desired >= self.min_slots:
                break
            clock.sleep(0.01)
        raw_restore: Optional[Dict[str, Any]] = None
        while not self._stop.is_set():
            with self._lock:
                self._slots = self._desired_slots
            parallelism = max(self.min_slots, self._slots)
            plan = self.plan_factory(parallelism)
            # split the snapshot for the parallelism we ACTUALLY deploy at —
            # desired slots may have moved again since the savepoint was
            # taken, and restoring N-way-split state into M subtasks would
            # silently drop/misroute key-group ranges
            if raw_restore is not None:
                counts = {
                    v.uid: (len(v.chain[0].source.create_splits(parallelism))
                            if v.is_source else parallelism)
                    for v in plan.vertices}
                restore = rescale_snapshot(raw_restore, plan, counts)
            else:
                restore = None
            cluster = MiniCluster(
                checkpoint_storage=self.checkpoint_storage,
                checkpoint_interval_ms=self.checkpoint_interval_ms)
            self._cluster = cluster
            self.state = SchedulerStates.EXECUTING
            done: Dict[str, Any] = {}

            def run_job(pl=plan, cl=cluster, rs=restore):
                done["result"] = cl.execute(pl, restore=rs, timeout_s=600)

            th = threading.Thread(target=run_job, daemon=True)
            th.start()
            rescale_to: Optional[int] = None
            while th.is_alive():
                if self._stop.is_set():
                    cluster.cancel()
                    break
                with self._lock:
                    if self._desired_slots != parallelism and \
                            self._desired_slots >= self.min_slots:
                        rescale_to = self._desired_slots
                if rescale_to is not None:
                    break
                clock.sleep(0.01)
            if rescale_to is not None:
                # take a consistent cut and stop; the split happens at the
                # top of the loop for whatever parallelism wins
                self.state = SchedulerStates.RESTARTING
                sp = cluster.savepoint()
                cluster.cancel()
                th.join(timeout=60)
                raw_restore = (self.checkpoint_storage.load(sp)
                               if sp is not None and self.checkpoint_storage
                               else cluster.latest_restore())
                self.rescales += 1
                continue
            th.join(timeout=60)
            result = done.get("result")
            self._result = result
            if result is None or self._stop.is_set():
                self.state = SchedulerStates.CANCELED
                return
            if result.state == "FINISHED":
                self.state = SchedulerStates.FINISHED
                return
            if result.state == "CANCELED":
                self.state = SchedulerStates.CANCELED
                return
            # failure: consult the restart strategy
            self.restart_strategy.notify_failure()
            if not self.restart_strategy.can_restart():
                self.state = SchedulerStates.FAILED
                return
            self.state = SchedulerStates.RESTARTING
            clock.sleep(self.restart_strategy.delay_ms() / 1000.0)
            raw_restore = (self.checkpoint_storage.load_latest()
                           if self.checkpoint_storage else
                           self._cluster.latest_restore())
        self.state = SchedulerStates.CANCELED


# ---------------------------------------------------------------------------
# reactive autoscaler: rescale under fire, no drain
# ---------------------------------------------------------------------------

class AutoscalerPolicy:
    """Hysteresis over the job's backpressure signals -> target parallelism.

    Pure decision logic (unit-testable without a cluster): feed it one
    ``signals`` dict per poll — ``max_queue_depth`` /
    ``alignment_queued_elements`` / ``backpressured_ms_delta`` straight
    off ``MiniCluster.backpressure_totals()``, plus an optional
    ``latency_p99_ms`` from the per-(source, hop) histograms — and
    it answers with a new target parallelism or None.

    Hysteresis has three legs, all deliberately boring:

    - **sustain**: a scale decision needs ``sustain_polls`` CONSECUTIVE
      overloaded (resp. underloaded) polls — one deep batch is noise.
    - **dead band**: the scale-out and scale-in thresholds are far apart;
      signals between them reset nothing and decide nothing.
    - **cooldown**: after any decision the policy is silent for
      ``cooldown_ms``, measured through a :class:`MonotoneElapsed` on the
      injectable clock seam — a chaos ``ClockSkew`` backward step cannot
      re-arm an expired cooldown or hold one open forever, so skew cannot
      manufacture a rescale storm.
    """

    def __init__(self, *, min_parallelism: int = 1, max_parallelism: int = 8,
                 scale_factor: int = 2,
                 scale_out_queue_depth: int = 24,
                 scale_in_queue_depth: int = 2,
                 scale_out_alignment_queued: int = 1024,
                 scale_out_backpressured_ms: Optional[float] = None,
                 scale_out_p99_ms: Optional[float] = None,
                 sustain_polls: int = 3, cooldown_ms: float = 2000.0,
                 clock_obj=None):
        if min_parallelism < 1 or max_parallelism < min_parallelism:
            raise ValueError("AutoscalerPolicy: need 1 <= min <= max")
        if scale_factor < 2:
            raise ValueError("AutoscalerPolicy: scale_factor must be >= 2")
        self.min_parallelism = min_parallelism
        self.max_parallelism = max_parallelism
        self.scale_factor = scale_factor
        self.scale_out_queue_depth = scale_out_queue_depth
        self.scale_in_queue_depth = scale_in_queue_depth
        self.scale_out_alignment_queued = scale_out_alignment_queued
        self.scale_out_backpressured_ms = scale_out_backpressured_ms
        self.scale_out_p99_ms = scale_out_p99_ms
        self.sustain_polls = max(1, int(sustain_polls))
        self.cooldown_ms = float(cooldown_ms)
        self._clock = clock_obj
        self._over = 0
        self._under = 0
        self._cooldown: Optional[MonotoneElapsed] = None

    # -- introspection -----------------------------------------------------
    def cooldown_remaining_ms(self) -> float:
        if self._cooldown is None:
            return 0.0
        return max(0.0, self.cooldown_ms - self._cooldown.ms())

    def in_cooldown(self) -> bool:
        return self.cooldown_remaining_ms() > 0.0

    def restart_cooldown(self) -> None:
        """(Re-)arm the cooldown — the autoscaler calls this when a rescale
        actually COMPLETES, so the window measures from redeploy, not from
        the decision."""
        self._cooldown = MonotoneElapsed(self._clock)

    def cancel_cooldown(self) -> None:
        """Disarm the decision-time cooldown: a decided rescale that could
        not execute (no cut possible) must not silence the policy for a
        full cooldown window while the job keeps drowning."""
        self._cooldown = None

    # -- classification ----------------------------------------------------
    def _overloaded(self, s: Dict[str, Any]) -> bool:
        if s.get("max_queue_depth", 0) >= self.scale_out_queue_depth:
            return True
        if s.get("alignment_queued_elements", 0) \
                >= self.scale_out_alignment_queued:
            return True
        bp = self.scale_out_backpressured_ms
        if bp is not None and s.get("backpressured_ms_delta", 0.0) >= bp:
            return True
        p99 = s.get("latency_p99_ms")
        return (self.scale_out_p99_ms is not None and p99 is not None
                and p99 >= self.scale_out_p99_ms)

    def _underloaded(self, s: Dict[str, Any]) -> bool:
        if s.get("max_queue_depth", 0) > self.scale_in_queue_depth:
            return False
        if s.get("alignment_queued_elements", 0) > 0:
            return False
        bp = self.scale_out_backpressured_ms
        if bp is not None and s.get("backpressured_ms_delta", 0.0) > bp / 4:
            return False
        return True

    def observe(self, signals: Dict[str, Any],
                current: int) -> Optional[int]:
        """One poll: returns the new target parallelism, or None.  The
        caller performs the rescale; :meth:`restart_cooldown` re-arms the
        window once the new deployment is live."""
        if self.in_cooldown():
            # signals during cooldown neither decide nor accumulate — the
            # whole point is to let the new deployment's queues settle
            self._over = self._under = 0
            return None
        if self._overloaded(signals):
            self._over += 1
            self._under = 0
            if self._over >= self.sustain_polls \
                    and current < self.max_parallelism:
                self._over = self._under = 0
                self.restart_cooldown()
                return min(self.max_parallelism,
                           current * self.scale_factor)
        elif self._underloaded(signals):
            self._under += 1
            self._over = 0
            if self._under >= self.sustain_polls \
                    and current > self.min_parallelism:
                self._over = self._under = 0
                self.restart_cooldown()
                return max(self.min_parallelism,
                           max(1, current // self.scale_factor))
        else:
            self._over = self._under = 0   # dead band
        return None


class ReactiveAutoscaler:
    """FLIP-160's reactive loop closed over the live backpressure signals:
    run the job, watch its gauges, and rescale it MID-STREAM through an
    unaligned checkpoint — the backpressured job is never drained.

    Rescale lifecycle (each phase an instant on the ``rescale`` trace
    span; the whole window bounded by ``rescale_deadline_ms`` through the
    clock seam):

    1. **trigger** — take a fresh cut of the RUNNING job via
       ``MiniCluster.checkpoint()`` (regular barriers: they escalate to
       unaligned under backpressure, so the cut completes in bounded time
       precisely when the job is drowning).
    2. **checkpoint** — load the cut (the immutable pre-rescale anchor).
    3. **redistribute** — ``rescale_snapshot``: keyed operator state
       re-splits by key-group range and the persisted in-flight channel
       state re-routes by each record's own key.  The
       ``rescale.redistribute`` chaos point fires here; an injected kill
       (``KillDuringRescale``) is absorbed by re-triggering from the same
       cut (idempotent — the cut never mutates), bounded by
       ``rescale_retries`` and the deadline, after which the lifecycle
       ROLLS BACK: redeploy the OLD parallelism from the same cut.
    4. **redeploy** — cancel the old deployment, deploy the new plan with
       the redistributed restore; a worker dying after this point is
       handled by the cluster's own restart strategy, whose restore path
       redistributes the pre-rescale checkpoint again
       (``maybe_rescale_restore``) — same idempotent re-trigger.
    5. **first-output** — the span completes when the new deployment
       processes its first records.

    Exactly-once across all of it: every pre-cut record is either in the
    operator snapshots or in the redistributed channel state (exactly
    once), and every post-cut record replays from the source offsets.
    """

    def __init__(self, plan_factory: Callable[[int], ExecutionPlan],
                 checkpoint_storage=None, *,
                 policy: Optional[AutoscalerPolicy] = None,
                 initial_parallelism: Optional[int] = None,
                 poll_interval_ms: float = 25.0,
                 rescale_deadline_ms: float = 60_000.0,
                 rescale_retries: int = 1,
                 checkpoint_interval_ms: int = 20,
                 alignment_timeout_ms: Optional[float] = 100.0,
                 checkpoint_timeout_s: float = 30.0,
                 restart_attempts: int = 2,
                 channel_capacity: int = 32,
                 job_timeout_s: float = 600.0,
                 latency_interval_ms: Optional[int] = None,
                 incremental: bool = False):
        self.plan_factory = plan_factory
        self.checkpoint_storage = checkpoint_storage
        self.incremental = bool(incremental)
        self.policy = policy or AutoscalerPolicy()
        self.poll_interval_ms = float(poll_interval_ms)
        self.rescale_deadline_ms = float(rescale_deadline_ms)
        self.rescale_retries = int(rescale_retries)
        self.checkpoint_interval_ms = checkpoint_interval_ms
        self.alignment_timeout_ms = alignment_timeout_ms
        self.checkpoint_timeout_s = checkpoint_timeout_s
        self.restart_attempts = restart_attempts
        self.channel_capacity = channel_capacity
        self.job_timeout_s = job_timeout_s
        self.latency_interval_ms = latency_interval_ms
        self.state = SchedulerStates.CREATED
        self.error: Optional[str] = None
        self.parallelism = (initial_parallelism
                            if initial_parallelism is not None
                            else self.policy.min_parallelism)
        self.target_parallelism = self.parallelism
        self.parallelism_path: List[int] = [self.parallelism]
        self.rescales = 0
        self.rollbacks = 0
        self.retriggers = 0
        self.rescales_skipped = 0
        self.last_rescale_duration_ms: Optional[float] = None
        self._last_signals: Dict[str, Any] = {}
        self._last_bp_ms = 0.0
        self._cluster: Optional[MiniCluster] = None
        self._result: Optional[JobResult] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ReactiveAutoscaler":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="reactive-autoscaler")
        self._thread.start()
        return self

    def cancel(self) -> None:
        self._stop.set()
        c = self._cluster
        if c is not None:
            c.cancel()

    def join(self, timeout_s: float = 300.0) -> Optional[JobResult]:
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
        return self._result

    # -- observability -----------------------------------------------------
    def status(self) -> Dict[str, Any]:
        """``job_status()["autoscaler"]`` / ``autoscaler.*`` gauge view."""
        with self._lock:
            return {
                "state": self.state,
                "current_parallelism": self.parallelism,
                "target_parallelism": self.target_parallelism,
                "min_parallelism": self.policy.min_parallelism,
                "max_parallelism": self.policy.max_parallelism,
                "rescales": self.rescales,
                "rollbacks": self.rollbacks,
                "retriggers": self.retriggers,
                "rescales_skipped": self.rescales_skipped,
                "last_rescale_duration_ms": self.last_rescale_duration_ms,
                "cooldown_remaining_ms": round(
                    self.policy.cooldown_remaining_ms(), 1),
                "parallelism_path": list(self.parallelism_path),
                "signals": dict(self._last_signals),
            }

    def _read_signals(self, cluster: MiniCluster) -> Dict[str, Any]:
        bp = cluster.backpressure_totals()
        total_ms = bp.get("total_backpressured_ms", 0.0)
        delta = max(0.0, total_ms - self._last_bp_ms)
        self._last_bp_ms = total_ms
        p99 = None
        rows = cluster.latency_tracker.panel()
        if rows:
            p99 = max(r.get("p99_ms", 0.0) for r in rows)
        signals = {"max_queue_depth": bp.get("max_queue_depth", 0),
                   "alignment_queued_elements":
                       bp.get("alignment_queued_elements", 0),
                   "backpressured_ms_delta": round(delta, 3),
                   "total_backpressured_ms": total_ms,
                   "latency_p99_ms": p99}
        with self._lock:
            self._last_signals = signals
        return signals

    # -- internals ---------------------------------------------------------
    def _make_cluster(self) -> MiniCluster:
        from flink_tpu_torch.metrics.groups import autoscaler_metrics

        cluster = MiniCluster(
            checkpoint_storage=self.checkpoint_storage,
            checkpoint_interval_ms=self.checkpoint_interval_ms,
            alignment_timeout_ms=self.alignment_timeout_ms,
            checkpoint_timeout_s=self.checkpoint_timeout_s,
            restart_attempts=self.restart_attempts,
            channel_capacity=self.channel_capacity,
            tolerable_failed_checkpoints=-1,
            latency_interval_ms=self.latency_interval_ms,
            incremental=self.incremental)
        cluster.autoscaler_status_supplier = self.status
        autoscaler_metrics(cluster.job_metric_group, self.status)
        # incarnation fencing: the new deployment's checkpoint ids start
        # ABOVE everything previous incarnations stored, so load_latest()
        # can never prefer an abandoned incarnation's checkpoint
        base = getattr(self, "_next_cid_base", 0)
        if base:
            cluster._next_checkpoint_id = base
        return cluster

    def _split_for(self, raw: Dict[str, Any],
                   plan: ExecutionPlan) -> Dict[str, Any]:
        return rescale_snapshot(raw, plan, counts_for_plan(plan))

    def _take_cut(self, cluster: MiniCluster,
                  deadline: MonotoneElapsed) -> Optional[int]:
        """A fresh consistent cut of the running job: regular (escalatable)
        checkpoint — returns its id or None when no cut is possible."""
        budget_s = max(0.5, (self.rescale_deadline_ms - deadline.ms())
                       / 1000.0 / 2.0)
        return cluster.checkpoint(timeout_s=min(budget_s,
                                                self.checkpoint_timeout_s))

    def _run(self) -> None:
        try:
            self._run_inner()
        except Exception as e:  # noqa: BLE001 — scheduler thread must not die silently
            self.error = f"{type(e).__name__}: {e}"
            self.state = SchedulerStates.FAILED

    def _run_inner(self) -> None:
        pending: Optional[Tuple[ExecutionPlan, Optional[Dict[str, Any]]]] \
            = None
        raw_restore: Optional[Dict[str, Any]] = None
        restarts = 0
        while not self._stop.is_set():
            if pending is not None:
                plan, restore = pending
                pending = None
            else:
                plan = self.plan_factory(self.parallelism)
                restore = (self._split_for(raw_restore, plan)
                           if raw_restore is not None else None)
            cluster = self._make_cluster()
            self._cluster = cluster
            self._last_bp_ms = 0.0
            self.state = SchedulerStates.EXECUTING
            done: Dict[str, Any] = {}

            def run_job(pl=plan, cl=cluster, rs=restore):
                done["result"] = cl.execute(pl, restore=rs,
                                            timeout_s=self.job_timeout_s)

            th = threading.Thread(target=run_job, daemon=True)
            th.start()
            span_t0 = getattr(self, "_span_t0", None)
            decision: Optional[int] = None
            while th.is_alive():
                if self._stop.is_set():
                    cluster.cancel()
                    break
                if span_t0 is not None:
                    # first-output detection: the rescale span ends when
                    # the NEW deployment processes records again
                    import time as _time
                    if any(t.records_in > 0
                           for t in getattr(cluster, "_tasks", [])
                           if not hasattr(t, "split")):
                        dur_ns = _time.perf_counter_ns() - span_t0
                        tracing.complete(
                            "rescale", span_t0, _time.perf_counter_ns(),
                            cat="rescale",
                            from_parallelism=self._span_from,
                            to_parallelism=self.parallelism,
                            rolled_back=self._span_rolled_back,
                            retriggers=self.retriggers)
                        with self._lock:
                            self.last_rescale_duration_ms = round(
                                dur_ns / 1e6, 1)
                        self.policy.restart_cooldown()
                        span_t0 = None
                        self._span_t0 = None
                signals = self._read_signals(cluster)
                target = self.policy.observe(signals, self.parallelism)
                if target is not None and target != self.parallelism:
                    attempt = self._rescale(cluster, th, target)
                    if attempt is None:
                        # no cut possible (job finishing / sources done):
                        # the deployment keeps running, monitoring resumes
                        # — and the decision-time cooldown disarms so the
                        # next sustained overload re-attempts promptly
                        self.policy.cancel_cooldown()
                        with self._lock:
                            self.rescales_skipped += 1
                        continue
                    decision = target
                    pending = attempt
                    break
                clock.sleep(self.poll_interval_ms / 1000.0)
            if decision is None:
                th.join(timeout=self.job_timeout_s)
                result = done.get("result")
                self._result = result
                if result is None or self._stop.is_set():
                    self.state = SchedulerStates.CANCELED
                    return
                if result.state == "FINISHED":
                    self.state = SchedulerStates.FINISHED
                    return
                if result.state == "CANCELED":
                    self.state = SchedulerStates.CANCELED
                    return
                # execution failed past the cluster's own restart budget:
                # re-trigger from the newest durable state (idempotent —
                # a worker killed mid-redeploy lands here and redeploys
                # from the same pre-rescale checkpoint)
                if restarts >= self.restart_attempts:
                    self.state = SchedulerStates.FAILED
                    self.error = result.error
                    return
                restarts += 1
                self.state = SchedulerStates.RESTARTING
                raw_restore = (self.checkpoint_storage.load_latest()
                               if self.checkpoint_storage is not None
                               else cluster.latest_restore()) or raw_restore
                continue
            # ---- rescale under fire: the next iteration deploys the
            # already-redistributed (plan, restore) from ``pending``
            raw_restore = self._raw_cut
        self.state = SchedulerStates.CANCELED

    def _rescale(self, cluster: MiniCluster, th: threading.Thread,
                 target: int
                 ) -> Optional[Tuple[ExecutionPlan, Dict[str, Any]]]:
        """Execute one supervised rescale: cut -> cancel -> redistribute
        (retried, chaos-exposed) -> return the (plan, restore) to deploy.
        Rolls back to the old parallelism past the retry/deadline budget.
        Returns None when no cut could be taken (the job keeps running)."""
        import time as _time

        old_p = self.parallelism
        deadline = MonotoneElapsed()
        t0 = _time.perf_counter_ns()
        if getattr(self, "_span_t0", None) is not None:
            # back-to-back rescale decided before the previous
            # deployment's first output: close the previous span now
            # (truncated at this trigger) so its timeline row exists and
            # the new rescale's bookkeeping cannot clobber it
            tracing.complete("rescale", self._span_t0, t0, cat="rescale",
                             from_parallelism=self._span_from,
                             to_parallelism=old_p,
                             rolled_back=self._span_rolled_back,
                             truncated=True)
            with self._lock:
                self.last_rescale_duration_ms = round(
                    (t0 - self._span_t0) / 1e6, 1)
            self._span_t0 = None
        tracing.instant("rescale.trigger", cat="rescale",
                        from_parallelism=old_p, to_parallelism=target)
        with self._lock:
            self.target_parallelism = target
        self.state = SchedulerStates.RESTARTING
        cid = self._take_cut(cluster, deadline)
        if cid is None:
            with self._lock:
                self.target_parallelism = old_p
            self.state = SchedulerStates.EXECUTING
            return None
        tracing.instant("rescale.checkpoint", cat="rescale", checkpoint=cid)
        raw = (self.checkpoint_storage.load(cid)
               if self.checkpoint_storage is not None
               else cluster.latest_restore())
        self._raw_cut = raw
        cluster.cancel()
        th.join(timeout=60)
        while th.is_alive() and deadline.ms() < self.rescale_deadline_ms:
            th.join(timeout=1.0)
        if th.is_alive():
            # the old incarnation refuses to die (a wedged subtask, a
            # stuck chaos stall): deploying the new one on top would run
            # both against the SAME shared sink/operator instances — the
            # exactly-once race the deploy barrier closes, resurrected
            # across incarnations.  Fail LOUDLY instead.
            raise RuntimeError(
                f"rescale {old_p}->{target}: old deployment still alive "
                f"after cancel + {self.rescale_deadline_ms:.0f}ms deadline "
                f"— refusing to deploy a second incarnation over it")
        # incarnation fencing: the OLD deployment's periodic checkpoints
        # may have completed AFTER the cut (higher ids) — they describe an
        # abandoned future the new deployment will re-derive differently.
        # Re-store the cut as the newest id and start the next
        # incarnation's ids above it, so any restart restores the cut (or
        # the new incarnation's own later checkpoints), never an orphan.
        if self.checkpoint_storage is not None:
            last = max(list(cluster._completed_ids) + [cid])
            if last > cid:
                self.checkpoint_storage.store(last + 1, raw)
                self._next_cid_base = last + 2
            else:
                self._next_cid_base = cid + 1
        else:
            self._next_cid_base = cid + 1
        attempts = 0
        new_p = target
        rolled_back = False
        while True:
            try:
                plan = self.plan_factory(new_p)
                restore = self._split_for(raw, plan)
                tracing.instant("rescale.redistribute", cat="rescale",
                                to_parallelism=new_p)
                # redeploy fault point: deterministic deploy-step failures
                chaos.fire("rescale.redeploy", to_parallelism=new_p)
                tracing.instant("rescale.redeploy", cat="rescale",
                                to_parallelism=new_p)
                break
            except Exception as e:  # noqa: BLE001 — the rescale window is a failure domain
                if not rolled_back and attempts < self.rescale_retries \
                        and deadline.ms() < self.rescale_deadline_ms:
                    # idempotent re-trigger: the cut is immutable, so the
                    # redistribution simply runs again
                    attempts += 1
                    with self._lock:
                        self.retriggers += 1
                    continue
                if rolled_back:
                    # even the rollback deploy failed: surface it
                    raise
                rolled_back = True
                with self._lock:
                    self.rollbacks += 1
                    self.target_parallelism = old_p
                new_p = old_p
                self.error = (f"rescale {old_p}->{target} rolled back: "
                              f"{type(e).__name__}: {e}")
        with self._lock:
            self.parallelism = new_p
            self.target_parallelism = new_p
            if not rolled_back:
                self.rescales += 1
            self.parallelism_path.append(new_p)
        self._span_t0 = t0
        self._span_from = old_p
        self._span_rolled_back = rolled_back
        return plan, restore

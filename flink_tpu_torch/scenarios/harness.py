"""Scenario lifecycle harness (port of ``flink_tpu/scenarios/harness.py``).

One :class:`ScenarioHarness` run is two legs over the SAME generated
diurnal stream:

1. **Faulted leg** — the real production shape: the scenario's topology
   (transactional Kafka sinks, queryable operators) runs under the
   :class:`ReactiveAutoscaler`; a fixed per-dequeue consumer cost makes
   drain capacity proportional to parallelism, so the diurnal peak
   backpressures the job and the autoscaler rescales through unaligned
   cuts with channel-state redistribution.  When the curve reaches its
   peak the scenario's nemeses arm (worker kill, SlowConsumer bursts,
   ``KillDuringRescale``; the bench tier adds ``WedgedDevice``).  If the
   scenario publishes queryable state, routed binary
   ``QueryableStateClientPool`` readers sustain a paced QPS
   against the RUNNING job, reconnecting across rescales.
2. **Control leg** — the same scenario and a bit-identical fresh source
   (same seed), unpaced, fixed parallelism, no chaos.

Verification: per-topic COMMITTED rows (the broker only exposes
EndTxn-committed transactions — read-committed semantics) are compared
as multisets: missing rows = lost, extra rows = duplicated, and the
canonical digests must match exactly; scenario ``cross_check`` hooks add
ground-truth checks (e.g. sessionized_analytics replays the stream
through the SQL planner's TUMBLE and diffs the answers).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.scenarios.base import Scenario, ScenarioSpec
from flink_tpu_torch.testing import chaos

#: curve fraction at which the peak nemeses arm (the sine curve's upslope
#: shoulder: backpressure is building, the autoscaler's first scale-out
#: lands around here)
PEAK_ARM_FRAC = 0.35


class _ConsumerCost(chaos.FaultSchedule):
    """Fixed per-dequeue cost on ``channel.recv`` — the consumer-cost
    model that makes drain capacity proportional to the number of
    consuming subtasks (the reason scale-out helps) — plus, once
    :meth:`arm` fires at the peak, a bursty :class:`SlowConsumer` riding
    the SAME point (one point holds one schedule)."""

    def __init__(self, cost_s: float, slow: chaos.SlowConsumer):
        self.cost_s = cost_s
        self.slow = slow
        self._armed = threading.Event()

    def arm(self) -> None:
        self._armed.set()

    def matches(self, ctx) -> bool:
        return True

    def action(self, n, rng):
        extra = 0.0
        if self._armed.is_set():
            act = self.slow.action(n, rng)
            if isinstance(act, tuple) and act[0] == "delay":
                extra = act[1]
        return ("delay", self.cost_s + extra)


class _QueryableReader:
    """Paced routed-binary read leg against the running job's queryable
    state (the routed binary client threaded into the scenarios).
    Tolerates rescales: when the autoscaler
    swaps clusters the old server goes dark; the reader evicts its pool,
    starts the new cluster's server and reconnects."""

    def __init__(self, scaler, spec: ScenarioSpec):
        self.scaler = scaler
        self.spec = spec
        self.stats = {"lookups": 0, "found": 0, "batches": 0, "errors": 0,
                      "reconnects": 0, "routed_batches": 0,
                      "json_fallbacks": 0}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"scenario-reader-{spec.name}")
        rng = np.random.default_rng(spec.seed + 1)
        self._keys = rng.integers(0, spec.keys,
                                  spec.qps_batch_keys).astype(np.int64)
        self._wall_s = 0.0

    def start(self) -> "_QueryableReader":
        self._thread.start()
        return self

    def stop(self) -> Dict[str, Any]:
        self._stop.set()
        self._thread.join(timeout=10)
        out = dict(self.stats)
        out["lookups_per_sec"] = round(
            self.stats["lookups"] / self._wall_s, 1) if self._wall_s else 0.0
        return out

    def _run(self) -> None:
        from flink_tpu_torch.queryable import QueryableStateClientPool

        interval = (self.spec.qps_batch_keys / self.spec.qps_target
                    if self.spec.qps_target > 0 else 0.05)
        pool: Optional[QueryableStateClientPool] = None
        bound_cluster = None
        t0 = time.monotonic()
        try:
            while not self._stop.is_set():
                cluster = getattr(self.scaler, "_cluster", None)
                if cluster is None or cluster.queryable is None:
                    time.sleep(0.05)
                    continue
                try:
                    if cluster is not bound_cluster:
                        if pool is not None:
                            self._harvest(pool)
                            pool.close()
                            pool = None
                            self.stats["reconnects"] += 1
                        if bound_cluster is not None \
                                and bound_cluster.queryable is not None:
                            # the superseded incarnation is cancelled; its
                            # serving threads must not outlive it
                            try:
                                bound_cluster.queryable.close()
                            except Exception:  # noqa: BLE001
                                pass
                        server = cluster.start_queryable_server()
                        pool = QueryableStateClientPool(
                            server.host, server.port, protocol="auto",
                            routing=True, timeout_s=2.0)
                        bound_cluster = cluster
                    t_req = time.monotonic()
                    ans = pool.get_batch(self.spec.queryable_state,
                                         self._keys, consistency="live")
                    self.stats["lookups"] += int(self._keys.size)
                    self.stats["batches"] += 1
                    self.stats["found"] += int(sum(ans["found"]))
                except Exception:  # noqa: BLE001 — rescale windows sever us
                    self.stats["errors"] += 1
                    bound_cluster = None
                    time.sleep(0.05)
                    continue
                sleep_left = interval - (time.monotonic() - t_req)
                if sleep_left > 0:
                    time.sleep(sleep_left)
        finally:
            self._wall_s = time.monotonic() - t0
            if pool is not None:
                self._harvest(pool)
                try:
                    pool.close()
                except Exception:  # noqa: BLE001
                    pass

    def _harvest(self, pool) -> None:
        self.stats["routed_batches"] += pool.stats.get("routed_batches", 0)
        # 0 fallbacks == every routed batch rode the binary columnar wire
        self.stats["json_fallbacks"] += pool.stats.get("json_fallbacks", 0)


def canonical_rows(rows: List[dict]) -> List[str]:
    """Order-insensitive canonical form of committed sink rows."""
    return sorted(json.dumps(r, sort_keys=True) for r in rows)


def committed_digest(committed: Dict[str, List[dict]]) -> str:
    h = hashlib.sha256()
    for topic in sorted(committed):
        h.update(topic.encode())
        for line in canonical_rows(committed[topic]):
            h.update(line.encode())
            h.update(b"\n")
    return h.hexdigest()


def diff_committed(faulted: Dict[str, List[dict]],
                   control: Dict[str, List[dict]]) -> Tuple[int, int]:
    """(lost, duplicated) across all topics: rows the control committed
    that the faulted run did not (lost), and rows the faulted run
    committed beyond the control's multiset (duplicated)."""
    lost = dup = 0
    for topic in set(faulted) | set(control):
        fc = Counter(canonical_rows(faulted.get(topic, [])))
        cc = Counter(canonical_rows(control.get(topic, [])))
        lost += sum((cc - fc).values())
        dup += sum((fc - cc).values())
    return lost, dup


def consume_topic(broker, topic: str, partitions: int = 1) -> List[dict]:
    """All COMMITTED rows of a topic (staged transactions are invisible
    until EndTxn commit — the broker IS read-committed)."""
    from flink_tpu_torch.connectors.kafka import KafkaWireClient

    c = KafkaWireClient(broker.host, broker.port)
    try:
        out: List[dict] = []
        for p in range(partitions):
            hw = c.latest_offset(topic, p)
            off = 0
            while off < hw:
                msgs, _ = c.fetch(topic, p, off)
                if not msgs:
                    break
                for o, _k, v in msgs:
                    if o >= hw:
                        break
                    if v:
                        out.append(json.loads(v.decode()))
                    off = o + 1
        return out
    finally:
        c.close()


class LegResult:
    def __init__(self):
        self.state: str = "Unknown"
        self.error: Optional[str] = None
        self.committed: Dict[str, List[dict]] = {}
        self.source = None
        self.rescales = 0
        self.rollbacks = 0
        self.retriggers = 0
        self.parallelism_path: List[int] = []
        self.peak: Dict[str, float] = {}
        self.latency_p99_ms: Optional[float] = None
        self.nemeses: List[str] = []
        self.queryable: Dict[str, Any] = {}
        self.wall_ms: float = 0.0


class ScenarioHarness:
    """Drives one scenario end to end; see the module docstring."""

    def __init__(self, scenario: Scenario, smoke: bool = False,
                 records: Optional[int] = None, keys: Optional[int] = None,
                 base_dir: Optional[str] = None,
                 full_nemeses: bool = False,
                 consumer_cost_s: float = 0.010,
                 job_timeout_s: float = 600.0):
        self.scenario = scenario
        self.spec = scenario.spec(smoke, records=records, keys=keys)
        self._own_dir = base_dir is None
        self.base_dir = base_dir or tempfile.mkdtemp(
            prefix=f"scenario-{scenario.name}-")
        self.full_nemeses = full_nemeses
        self.consumer_cost_s = consumer_cost_s
        self.job_timeout_s = job_timeout_s

    # -- legs --------------------------------------------------------------
    def _make_sinks(self, broker) -> Dict[str, Any]:
        from flink_tpu_torch.connectors.kafka import KafkaExactlyOnceSink

        return {t: KafkaExactlyOnceSink(
                    broker.host, broker.port, t,
                    sink_id=f"{self.scenario.name}-{t}", buffer_rows=512)
                for t in self.spec.topics}

    def _run_faulted(self) -> LegResult:
        from flink_tpu_torch.cluster.adaptive import (AutoscalerPolicy,
                                                ReactiveAutoscaler)
        from flink_tpu_torch.connectors.kafka import KafkaWireBroker
        from flink_tpu_torch.runtime.checkpoint.storage import \
            InMemoryCheckpointStorage

        res = LegResult()
        spec = self.spec
        broker = KafkaWireBroker(
            directory=os.path.join(self.base_dir, "faulted-kafka")).start()
        try:
            for t in spec.topics:
                broker.create_topic(t, partitions=1)
            source = self.scenario.make_source(spec, paced=True)
            res.source = source

            def plan_factory(parallelism):
                return self.scenario.plan(parallelism, source,
                                          self._make_sinks(broker), spec)

            policy = AutoscalerPolicy(
                min_parallelism=2, max_parallelism=4,
                scale_out_queue_depth=12, scale_in_queue_depth=2,
                sustain_polls=3, cooldown_ms=1500.0)
            scaler = ReactiveAutoscaler(
                plan_factory,
                checkpoint_storage=InMemoryCheckpointStorage(retain=10),
                policy=policy, initial_parallelism=2,
                poll_interval_ms=25.0, checkpoint_interval_ms=50,
                alignment_timeout_ms=100.0, restart_attempts=4,
                job_timeout_s=self.job_timeout_s,
                latency_interval_ms=50,
                # sub-second cuts stay affordable because delta
                # tracking ships increment bytes ∝ change rate — the 2PC
                # commit cadence stops being bounded by full-state bytes
                incremental=True)
            inj = chaos.FaultInjector(seed=spec.seed)
            cost = _ConsumerCost(
                self.consumer_cost_s,
                chaos.SlowConsumer(max_s=0.03, min_s=0.01, p=0.1, burst=8,
                                   times=400))
            inj.inject("channel.recv", cost)
            armed: Dict[str, Any] = {}
            reader = (_QueryableReader(scaler, spec).start()
                      if spec.queryable_state and spec.qps_target > 0
                      else None)
            p99_max: Optional[float] = None
            stop = threading.Event()

            def watch():
                nonlocal p99_max, armed
                wedge_seen_at: Optional[float] = None
                while not stop.is_set():
                    st = scaler.status()
                    p99 = st["signals"].get("latency_p99_ms")
                    if p99 is not None:
                        p99_max = p99 if p99_max is None \
                            else max(p99_max, p99)
                    if not armed \
                            and source.progress_frac() >= PEAK_ARM_FRAC:
                        armed = self.scenario.nemeses(
                            inj, spec, full=self.full_nemeses)
                        cost.arm()
                        armed["slow_consumer"] = cost.slow
                    wedge = armed.get("wedged_device")
                    if wedge is not None and wedge.wedged_once \
                            and not wedge.healed:
                        # give the watchdog time to quarantine, then heal
                        # so the background healer can re-promote
                        if wedge_seen_at is None:
                            wedge_seen_at = time.monotonic()
                        elif time.monotonic() - wedge_seen_at > 2.0:
                            wedge.heal()
                    time.sleep(0.05)

            t0 = time.monotonic()
            watcher = threading.Thread(target=watch, daemon=True)
            watcher.start()
            try:
                with chaos.installed(inj):
                    scaler.start()
                    scaler.join(timeout_s=self.job_timeout_s + 60)
            finally:
                stop.set()
                wedge = armed.get("wedged_device")
                if wedge is not None and not wedge.healed:
                    wedge.heal()            # release any parked sacrifice
                if scaler.state not in ("Finished", "Failed", "Canceled"):
                    scaler.cancel()
                watcher.join(timeout=5)
                if reader is not None:
                    res.queryable = reader.stop()
                cluster = getattr(scaler, "_cluster", None)
                if cluster is not None and cluster.queryable is not None:
                    cluster.queryable.close()
            res.wall_ms = round((time.monotonic() - t0) * 1000.0, 1)
            st = scaler.status()
            res.state = scaler.state
            res.error = scaler.error
            res.rescales = st["rescales"]
            res.rollbacks = st["rollbacks"]
            res.retriggers = st["retriggers"]
            res.parallelism_path = st["parallelism_path"]
            res.latency_p99_ms = p99_max
            res.peak = source.peak_stats()
            res.nemeses = sorted(armed)
            res.committed = {t: consume_topic(broker, t)
                             for t in spec.topics}
        finally:
            broker.stop()
        return res

    def _run_control(self) -> LegResult:
        from flink_tpu_torch.cluster.minicluster import MiniCluster
        from flink_tpu_torch.connectors.kafka import KafkaWireBroker
        from flink_tpu_torch.runtime.checkpoint.storage import \
            InMemoryCheckpointStorage

        res = LegResult()
        spec = self.spec
        broker = KafkaWireBroker(
            directory=os.path.join(self.base_dir, "control-kafka")).start()
        try:
            for t in spec.topics:
                broker.create_topic(t, partitions=1)
            source = self.scenario.make_source(spec, paced=False)
            res.source = source
            plan = self.scenario.plan(2, source, self._make_sinks(broker),
                                      spec)
            cluster = MiniCluster(
                checkpoint_storage=InMemoryCheckpointStorage(retain=5),
                checkpoint_interval_ms=50, alignment_timeout_ms=100.0,
                restart_attempts=2, incremental=True)
            t0 = time.monotonic()
            try:
                out = cluster.execute(plan, timeout_s=self.job_timeout_s)
                res.state = ("Finished" if out.state == "FINISHED"
                             else str(out.state).title())
                res.error = getattr(out, "error", None)
            finally:
                if cluster.queryable is not None:
                    cluster.queryable.close()
            res.wall_ms = round((time.monotonic() - t0) * 1000.0, 1)
            res.parallelism_path = [2]
            res.committed = {t: consume_topic(broker, t)
                             for t in spec.topics}
        finally:
            broker.stop()
        return res

    # -- coordinator HA: kill the leader at the peak ----------------------
    def run_ha_kill(self) -> Dict[str, Any]:
        """Coordinator-kill leg: leader A (epoch e) runs the scenario under
        a :class:`FileHaStore` lease; at the diurnal peak a
        ``KillCoordinator`` nemesis fails A's next lease renewal (loud
        demotion — A becomes a ZOMBIE that keeps executing), standby B
        acquires the lease at e+1, proves A's stale-epoch checkpoint
        completions are fenced by the HA store, recovers the job from the
        completed-checkpoint pointer (increment chains included) and runs
        it to completion.  Verified exactly like :meth:`run`: committed
        rows vs an unfaulted control leg — zero lost, zero duplicated,
        digest-identical — plus two unconditional fencing probes
        (``stale_pointer_rejected``, ``stale_commit_fenced``)."""
        from flink_tpu_torch.cluster.minicluster import MiniCluster
        from flink_tpu_torch.connectors.kafka import (KafkaExactlyOnceSink,
                                                KafkaWireBroker)
        from flink_tpu_torch.runtime import ha as ha_mod
        from flink_tpu_torch.runtime.checkpoint.incremental import \
            IncrementalCheckpointStorage

        spec = self.spec
        t_total = time.monotonic()
        result: Dict[str, Any] = {
            "scenario": self.scenario.name, "mode": "ha-kill",
            "smoke": spec.smoke, "records": spec.records, "keys": spec.keys,
        }
        # both leaders' clusters: their queryable services' threads end
        # with the leg (JAX's harness leaves them running)
        clusters: List[MiniCluster] = []
        try:
            broker = KafkaWireBroker(
                directory=os.path.join(self.base_dir, "ha-kafka")).start()
            try:
                for t in spec.topics:
                    broker.create_topic(t, partitions=1)
                store = ha_mod.FileHaStore(
                    os.path.join(self.base_dir, "ha-store"))
                storage = IncrementalCheckpointStorage(
                    os.path.join(self.base_dir, "ha-ckpts"), retain=6,
                    max_increments_per_base=4, compact_in_background=False)
                job_id = ha_mod.job_id_for(f"scenario-{self.scenario.name}")
                # retention (A's AND B's — shared storage)
                # never evicts the pointed-at cut, whole chain included
                storage.pin_provider = lambda: (
                    (store.completed_checkpoint(job_id) or {})
                    .get("checkpoint_id"))
                source = self.scenario.make_source(spec, paced=True)
                ttl = 0.75

                def make_cluster(epoch: int) -> MiniCluster:
                    c = MiniCluster(
                        checkpoint_storage=storage,
                        checkpoint_interval_ms=50,
                        alignment_timeout_ms=100.0,
                        restart_attempts=2, incremental=True)
                    # epoch-partitioned checkpoint ids: the zombie and the
                    # new leader share one directory without colliding
                    c._next_checkpoint_id = (epoch - 1) * 1_000_000 + 1

                    def gate(cid: int, _e: int = epoch) -> bool:
                        # the decisive fence: advancing the HA pointer
                        # re-verifies the store's leader epoch — a zombie
                        # fails HERE, before any notify fans out
                        try:
                            store.set_completed_checkpoint(job_id, cid, _e)
                            return True
                        except ha_mod.StaleEpochError:
                            return False
                    c.ha_commit_gate = gate
                    clusters.append(c)
                    return c

                inj = chaos.FaultInjector(seed=spec.seed)
                with chaos.installed(inj):
                    # -- leader A (epoch e) ---------------------------------
                    lease_a = store.acquire(f"leader-A-{os.getpid()}", ttl)
                    store.register_job(
                        job_id, {"scenario": self.scenario.name,
                                 "parallelism": 2}, lease_a.epoch)
                    demoted = threading.Event()
                    t_demote = [0.0]

                    def on_lost(exc: Exception) -> None:
                        t_demote[0] = time.monotonic()
                        demoted.set()

                    renewer_a = ha_mod.LeaseRenewer(
                        store, lease_a, ttl, on_lost=on_lost).start()
                    cluster_a = make_cluster(lease_a.epoch)
                    plan_a = self.scenario.plan(
                        2, source, self._make_sinks(broker), spec)
                    a_out: Dict[str, Any] = {}

                    def run_a() -> None:
                        try:
                            r = cluster_a.execute(
                                plan_a, timeout_s=self.job_timeout_s)
                            a_out["state"] = str(r.state)
                        except Exception as e:  # noqa: BLE001 — zombie dies
                            a_out["error"] = f"{type(e).__name__}: {e}"

                    thread_a = threading.Thread(target=run_a, daemon=True,
                                                name="ha-leader-A")
                    thread_a.start()
                    # arm the kill at the peak, once at least one cut has
                    # published a pointer (something to recover FROM)
                    deadline = time.monotonic() + self.job_timeout_s
                    while time.monotonic() < deadline and (
                            source.progress_frac() < PEAK_ARM_FRAC
                            or store.completed_checkpoint(job_id) is None):
                        time.sleep(0.02)
                    inj.inject("ha.lease", chaos.KillCoordinator(at=1))
                    demoted.wait(timeout=30)
                    renewer_a.stop()
                    renewer_a.join()
                    if not t_demote[0]:
                        t_demote[0] = time.monotonic()

                    # -- standby B takes over at epoch e+1 ------------------
                    lease_b = store.acquire(f"leader-B-{os.getpid()}", ttl,
                                            timeout_s=60.0)
                    renewer_b = ha_mod.LeaseRenewer(store, lease_b,
                                                    ttl).start()
                    # zombie probe: A is STILL RUNNING — its next
                    # completion must bounce off the store's epoch fence
                    probe_deadline = time.monotonic() + 10.0
                    while (cluster_a.ha_fenced_completions == 0
                           and thread_a.is_alive()
                           and time.monotonic() < probe_deadline):
                        time.sleep(0.02)
                    stale_pointer_rejected = \
                        cluster_a.ha_fenced_completions > 0
                    pointer = store.completed_checkpoint(job_id)
                    # stand the zombie down before the new incarnation
                    # deploys (its open transactions get swept by B's
                    # restore anyway)
                    cluster_a.cancel()
                    thread_a.join(timeout=60)

                    snap, restore_source = ha_mod.resolve_restore(
                        store, job_id, storage)
                    registered = store.load_job(job_id)
                    cluster_b = make_cluster(lease_b.epoch)
                    plan_b = self.scenario.plan(
                        int(registered.get("parallelism", 2)), source,
                        self._make_sinks(broker), spec)
                    b_out: Dict[str, Any] = {}

                    def run_b() -> None:
                        try:
                            r = cluster_b.execute(
                                plan_b, restore=snap,
                                timeout_s=self.job_timeout_s)
                            b_out["state"] = str(r.state)
                        except Exception as e:  # noqa: BLE001
                            b_out["error"] = f"{type(e).__name__}: {e}"

                    thread_b = threading.Thread(target=run_b, daemon=True,
                                                name="ha-leader-B")
                    thread_b.start()
                    # recovered = the NEW epoch completes a cut of its own
                    recover_deadline = time.monotonic() + self.job_timeout_s
                    while time.monotonic() < recover_deadline:
                        ptr = store.completed_checkpoint(job_id)
                        if ptr is not None and ptr["epoch"] >= lease_b.epoch:
                            break
                        if not thread_b.is_alive():
                            break
                        time.sleep(0.02)
                    recovery_ms = round(
                        (time.monotonic() - t_demote[0]) * 1000.0, 1)
                    thread_b.join(timeout=self.job_timeout_s + 60)
                    renewer_b.stop()
                    renewer_b.join()

                    # unconditional 2PC fence probe on a side topic (never
                    # part of the digest): a staged transaction notified
                    # under the OLD epoch must not commit
                    broker.create_topic("ha-probe", partitions=1)
                    psink = KafkaExactlyOnceSink(
                        broker.host, broker.port, "ha-probe",
                        sink_id="ha-probe", buffer_rows=4)
                    try:
                        h = tuple(psink.begin_transaction(psink.txn_name(0)))
                        psink.write_rows(h, [{"probe": 1}])
                        psink.pre_commit(h)
                        psink._staged.append((h, 1))
                        psink.fence_epoch = lease_b.epoch
                        psink.notify_checkpoint_complete(
                            1, epoch=lease_a.epoch)
                        fenced_nothing = (
                            psink.fenced_commits == 1
                            and not consume_topic(broker, "ha-probe"))
                        psink.notify_checkpoint_complete(
                            1, epoch=lease_b.epoch)
                        stale_commit_fenced = (
                            fenced_nothing
                            and len(consume_topic(broker, "ha-probe")) == 1)
                    finally:
                        psink.close()

                faulted_committed = {t: consume_topic(broker, t)
                                     for t in spec.topics}
                result.update({
                    "state": b_out.get("state", b_out.get("error",
                                                          "Unknown")),
                    "zombie_state": a_out.get("state",
                                              a_out.get("error", "Unknown")),
                    "leader_epochs": [lease_a.epoch, lease_b.epoch],
                    "recovery_ms": recovery_ms,
                    "restore_source": restore_source,
                    "fenced_completions": cluster_a.ha_fenced_completions,
                    "stale_pointer_rejected": bool(stale_pointer_rejected),
                    "stale_commit_fenced": bool(stale_commit_fenced),
                    "pointer": pointer,
                })
            finally:
                for c in clusters:
                    if c.queryable is not None:
                        c.queryable.close()
                broker.stop()

            control = self._run_control()
            lost, dup = diff_committed(faulted_committed, control.committed)
            f_digest = committed_digest(faulted_committed)
            c_digest = committed_digest(control.committed)
            committed_total = sum(len(r) for r in faulted_committed.values())
            result.update({
                "control_state": control.state,
                "control_error": control.error,
                "records_lost": int(lost),
                "records_duplicated": int(dup),
                "digest_match": f_digest == c_digest,
                "committed_rows": {t: len(r)
                                   for t, r in faulted_committed.items()},
                "control_rows": {t: len(r)
                                 for t, r in control.committed.items()},
                "ok": bool(result.get("state") == "FINISHED"
                           and control.state == "Finished"
                           and lost == 0 and dup == 0
                           and f_digest == c_digest and committed_total > 0
                           and result["stale_pointer_rejected"]
                           and result["stale_commit_fenced"]
                           and result["leader_epochs"][1]
                           > result["leader_epochs"][0]),
            })
        finally:
            if self._own_dir:
                shutil.rmtree(self.base_dir, ignore_errors=True)
        result["wall_ms"] = round((time.monotonic() - t_total) * 1000.0, 1)
        return result

    # -- the whole scenario ------------------------------------------------
    def run(self) -> Dict[str, Any]:
        spec = self.spec
        t0 = time.monotonic()
        try:
            faulted = self._run_faulted()
            control = self._run_control()
        finally:
            if self._own_dir:
                shutil.rmtree(self.base_dir, ignore_errors=True)
        lost, dup = diff_committed(faulted.committed, control.committed)
        f_digest = committed_digest(faulted.committed)
        c_digest = committed_digest(control.committed)
        cross = self.scenario.cross_check(faulted.committed, faulted.source,
                                          spec)
        cross += [f"control: {v}"
                  for v in self.scenario.cross_check(
                      control.committed, control.source, spec)]
        committed_total = sum(len(r) for r in faulted.committed.values())
        ok = (faulted.state == "Finished" and control.state == "Finished"
              and lost == 0 and dup == 0 and f_digest == c_digest
              and committed_total > 0 and not cross)
        result: Dict[str, Any] = {
            "scenario": self.scenario.name,
            "ok": bool(ok),
            "smoke": spec.smoke,
            "records": spec.records,
            "keys": spec.keys,
            "state": faulted.state,
            "error": faulted.error,
            "control_state": control.state,
            "control_error": control.error,
            "rescales": faulted.rescales,
            "rollbacks": faulted.rollbacks,
            "retriggers": faulted.retriggers,
            "parallelism_path": faulted.parallelism_path,
            "nemeses": faulted.nemeses,
            "peak_records_per_sec": faulted.peak.get(
                "peak_records_per_sec", 0.0),
            "latency_p99_ms": faulted.latency_p99_ms,
            "records_lost": int(lost),
            "records_duplicated": int(dup),
            "digest_match": f_digest == c_digest,
            "committed_rows": {t: len(r)
                               for t, r in faulted.committed.items()},
            "control_rows": {t: len(r)
                             for t, r in control.committed.items()},
            "cross_check_violations": cross,
            "queryable": faulted.queryable,
            "wall_ms": round((time.monotonic() - t0) * 1000.0, 1),
        }
        return result

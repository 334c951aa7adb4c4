"""Control plane: Dispatcher, JobMaster, ResourceManager, TaskExecutor
(port of ``flink_tpu/cluster/coordination.py``, host Python as JAX's).

Analogs of the reference's coordination endpoints (``Dispatcher.java:100``
``submitJob:299``, ``JobMaster.java:126`` ``startJobExecution:862``,
``resourcemanager/`` + ``slotmanager/SlotManager.java``,
``taskexecutor/TaskExecutor.java:181``), built on the single-threaded
RPC endpoints of :mod:`flink_tpu_torch.cluster.rpc` (the Akka analog — same
main-thread discipline, ``MainThreadValidatorUtil``).

Deployment model: slots are the scheduling currency exactly as in the
reference — TaskExecutors register slots with the ResourceManager, a
JobMaster declares requirements, the SlotManager matches.  On a granted
allocation the JobMaster runs its job's data plane as a MiniCluster sized
to the granted slots (threads + channels — the in-process execution tier);
multi-host deployments put these same gateways behind a network transport,
which is the seam ``RpcService.connect`` isolates (SURVEY §5.8).

The Dispatcher persists submitted job graphs through
:class:`flink_tpu_torch.cluster.ha.HaServices` and recovers them on start —
leader failover re-submits unfinished jobs (``Dispatcher`` recovery path).
A ``history_dir`` archives every terminal job for the history server
(``rest/history.py``).
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from flink_tpu_torch.cluster.heartbeat import HeartbeatManager
from flink_tpu_torch.cluster.minicluster import MiniCluster
from flink_tpu_torch.cluster.rpc import RpcEndpoint, RpcService, await_future


@dataclass
class SlotOffer:
    task_executor: str
    slot_id: int


class SlotManager:
    """Slot bookkeeping inside the ResourceManager
    (``SlotManager.java:50``): registered executor slots, allocation
    matching, release on executor loss."""

    def __init__(self):
        self._slots: Dict[Tuple[str, int], Optional[str]] = {}  # -> job_id

    def register_executor(self, te: str, num_slots: int) -> None:
        for s in range(num_slots):
            self._slots.setdefault((te, s), None)

    def unregister_executor(self, te: str) -> List[str]:
        """Remove an executor; returns job ids that lost slots."""
        lost = []
        for key in [k for k in self._slots if k[0] == te]:
            if self._slots[key] is not None:
                lost.append(self._slots[key])
            del self._slots[key]
        return sorted(set(lost))

    def free_slots(self) -> int:
        return sum(1 for v in self._slots.values() if v is None)

    def total_slots(self) -> int:
        return len(self._slots)

    def allocate(self, job_id: str, n: int) -> Optional[List[SlotOffer]]:
        free = [k for k, v in self._slots.items() if v is None]
        if len(free) < n:
            return None
        granted = free[:n]
        for k in granted:
            self._slots[k] = job_id
        return [SlotOffer(te, sid) for te, sid in granted]

    def release_job(self, job_id: str) -> int:
        n = 0
        for k, v in self._slots.items():
            if v == job_id:
                self._slots[k] = None
                n += 1
        return n


class TaskExecutorEndpoint(RpcEndpoint):
    """Worker agent (``TaskExecutor.java:181``): registers its slots with
    the ResourceManager and answers heartbeats."""

    def __init__(self, name: str, num_slots: int = 1):
        super().__init__(name)
        self.num_slots = num_slots
        self.last_heartbeat = 0.0

    def heartbeat(self) -> str:
        self.validate_runs_in_main_thread()
        self.last_heartbeat = time.monotonic()
        return self.name

    def slot_report(self) -> Tuple[str, int]:
        self.validate_runs_in_main_thread()
        return self.name, self.num_slots


class ResourceManagerEndpoint(RpcEndpoint):
    """Slot broker (``resourcemanager/`` + declarative ``SlotManager``)."""

    def __init__(self, rpc: RpcService, name: str = "resourcemanager",
                 heartbeat_interval_s: float = 0.2,
                 heartbeat_timeout_s: float = 1.0):
        super().__init__(name)
        self.rpc = rpc
        self.slot_manager = SlotManager()
        self._executors: Dict[str, Any] = {}
        self._lost_slot_listeners: List[Callable[[List[str]], None]] = []
        self._hb = HeartbeatManager(
            heartbeat_interval_s, heartbeat_timeout_s,
            on_timeout=self._executor_timed_out)

    def on_start(self) -> None:
        self._hb.start()

    def on_stop(self) -> None:
        self._hb.stop()

    def add_lost_slot_listener(self, fn: Callable[[List[str]], None]) -> None:
        self._lost_slot_listeners.append(fn)

    def register_task_executor(self, te_address: str) -> int:
        self.validate_runs_in_main_thread()
        gw = self.rpc.connect(te_address)
        te, slots = await_future(gw.slot_report())
        self.slot_manager.register_executor(te, slots)
        self._executors[te] = gw

        def ping(addr=te_address):
            try:
                g = self.rpc.connect(addr)
                name = await_future(g.heartbeat(), timeout_s=2.0)
                self._hb.receive_heartbeat(name)
            except (ConnectionError, Exception):  # noqa: BLE001
                pass

        from flink_tpu_torch.cluster.heartbeat import HeartbeatTarget
        self._hb.monitor_target(te, HeartbeatTarget(ping))
        return slots

    def _executor_timed_out(self, te: str) -> None:
        # heartbeat thread -> marshal into the endpoint main thread
        self.run_async(self._drop_executor, te)

    def _drop_executor(self, te: str) -> None:
        self.validate_runs_in_main_thread()
        self._executors.pop(te, None)
        self._hb.unmonitor_target(te)
        lost_jobs = self.slot_manager.unregister_executor(te)
        for fn in self._lost_slot_listeners:
            fn(lost_jobs)

    def request_slots(self, job_id: str, n: int) -> Optional[List[SlotOffer]]:
        self.validate_runs_in_main_thread()
        return self.slot_manager.allocate(job_id, n)

    def release_slots(self, job_id: str) -> int:
        self.validate_runs_in_main_thread()
        return self.slot_manager.release_job(job_id)

    def overview(self) -> Dict[str, int]:
        self.validate_runs_in_main_thread()
        return {"task_executors": len(self._executors),
                "slots_total": self.slot_manager.total_slots(),
                "slots_free": self.slot_manager.free_slots()}


class JobMasterEndpoint(RpcEndpoint):
    """Per-job coordinator (``JobMaster.java:126``): acquires slots from the
    RM, runs the data plane, reports status, handles cancel/savepoint."""

    def __init__(self, job_id: str, plan, rpc: RpcService,
                 rm_address: str, parallelism: int,
                 checkpoint_storage=None, checkpoint_interval_ms: int = 0,
                 on_finished: Optional[Callable[[str, Any], None]] = None):
        super().__init__(f"jobmaster-{job_id}")
        self.job_id = job_id
        self.plan = plan
        self.rpc = rpc
        self.rm_address = rm_address
        self.parallelism = parallelism
        self.checkpoint_storage = checkpoint_storage
        self.checkpoint_interval_ms = checkpoint_interval_ms
        self.on_finished = on_finished
        self.status = "CREATED"
        self.slots: List[SlotOffer] = []
        self.cluster: Optional[MiniCluster] = None
        self.result = None
        self._exec_thread: Optional[threading.Thread] = None
        self._stopped = False

    # -- lifecycle -----------------------------------------------------------
    def start_job_execution(self, restore=None) -> str:
        self.validate_runs_in_main_thread()
        if self.status == "RUNNING" or self._stopped:
            return self.status
        rm = self.rpc.connect(self.rm_address)
        offers = await_future(rm.request_slots(self.job_id, self.parallelism))
        if offers is None:
            self.status = "WAITING_FOR_RESOURCES"
            # declarative slot waiting: retry until resources appear
            # (reference: pending slot requests fulfilled by the SlotPool when
            # offers arrive; polling is the single-process equivalent)
            t = threading.Timer(0.1, lambda: self.run_async(
                self.start_job_execution, restore))
            t.daemon = True
            t.start()
            return self.status
        self.slots = offers
        self.cluster = MiniCluster(
            checkpoint_storage=self.checkpoint_storage,
            checkpoint_interval_ms=self.checkpoint_interval_ms)
        self.status = "RUNNING"

        def run():
            result = self.cluster.execute(self.plan, restore=restore,
                                          timeout_s=600)
            self.run_async(self._job_done, result)

        self._exec_thread = threading.Thread(
            target=run, daemon=True, name=f"jm-exec-{self.job_id}")
        self._exec_thread.start()
        return self.status

    def _job_done(self, result) -> None:
        self.validate_runs_in_main_thread()
        self._stopped = True
        self.result = result
        self.status = result.state
        try:
            rm = self.rpc.connect(self.rm_address)
            await_future(rm.release_slots(self.job_id))
        except ConnectionError:
            pass
        if self.on_finished is not None:
            self.on_finished(self.job_id, result)

    def cancel(self) -> str:
        self.validate_runs_in_main_thread()
        self._stopped = True
        if self.cluster is not None:
            self.cluster.cancel()
        else:
            # never deployed (e.g. still waiting for slots): terminal now
            from flink_tpu_torch.cluster.minicluster import JobResult
            self.status = "CANCELED"
            self._job_done(JobResult(self.job_id, "CANCELED", 0.0))
        return "CANCELLING"

    def trigger_savepoint(self) -> Optional[int]:
        self.validate_runs_in_main_thread()
        return self.cluster.savepoint() if self.cluster is not None else None

    def job_status(self) -> Dict[str, Any]:
        self.validate_runs_in_main_thread()
        base = {"job_id": self.job_id, "status": self.status,
                "slots": len(self.slots)}
        if self.cluster is not None:
            base.update(self.cluster.job_status())
            base["status"] = self.status
        return base


class DispatcherEndpoint(RpcEndpoint):
    """Job submission front door (``Dispatcher.java:100``): persists job
    graphs (HA), spawns one JobMaster per job, recovers on leader start."""

    def __init__(self, rpc: RpcService, rm_address: str,
                 ha_services=None, name: str = "dispatcher",
                 checkpoint_storage_factory: Optional[Callable[[str], Any]] = None,
                 plan_builder: Optional[Callable[[Any], Any]] = None,
                 history_dir: Optional[str] = None):
        super().__init__(name)
        self.rpc = rpc
        self.rm_address = rm_address
        self.ha = ha_services
        self.checkpoint_storage_factory = checkpoint_storage_factory
        #: archive terminal jobs here for the HistoryServer (FsJobArchivist)
        self.history_dir = history_dir
        #: rebuilds an ExecutionPlan from the picklable job spec persisted in
        #: HA (plans themselves hold operator closures — the durable artifact
        #: is the spec, like the reference persists the serialized JobGraph)
        self.plan_builder = plan_builder
        self._ids = itertools.count(1)
        self._jobs: Dict[str, Any] = {}       # job_id -> JobMaster gateway
        self._results: Dict[str, Any] = {}

    def on_start(self) -> None:
        # leader recovery: re-submit persisted, unfinished job graphs
        if self.ha is None:
            return
        if self.plan_builder is None:
            return
        for job_id in self.ha.job_ids():
            payload = self.ha.load_job(job_id)
            if payload is not None and "spec" in payload:
                plan = self.plan_builder(payload["spec"])
                self._spawn(job_id, plan, payload["parallelism"],
                            payload.get("checkpoint_interval_ms", 0),
                            restore_latest=True)

    def submit_job(self, plan, parallelism: int = 1,
                   checkpoint_interval_ms: int = 0,
                   job_spec: Any = None) -> str:
        """``job_spec``: optional PICKLABLE description of the job; with an
        HA store + a dispatcher ``plan_builder`` it makes the job leader-
        failover recoverable (plans themselves contain closures)."""
        self.validate_runs_in_main_thread()
        job_id = f"job-{next(self._ids):04d}"
        if self.ha is not None and job_spec is not None:
            self.ha.persist_job(job_id, {
                "spec": job_spec, "parallelism": parallelism,
                "checkpoint_interval_ms": checkpoint_interval_ms})
        self._spawn(job_id, plan, parallelism, checkpoint_interval_ms)
        return job_id

    def _spawn(self, job_id: str, plan, parallelism: int,
               checkpoint_interval_ms: int, restore_latest: bool = False) -> None:
        storage = (self.checkpoint_storage_factory(job_id)
                   if self.checkpoint_storage_factory else None)
        jm = JobMasterEndpoint(
            job_id, plan, self.rpc, self.rm_address, parallelism,
            checkpoint_storage=storage,
            checkpoint_interval_ms=checkpoint_interval_ms,
            on_finished=self._on_job_finished)
        gw = self.rpc.start_endpoint(jm)
        self._jobs[job_id] = gw
        restore = storage.load_latest() if (restore_latest and storage) else None
        gw.start_job_execution(restore)

    def _on_job_finished(self, job_id: str, result) -> None:
        # called from the JobMaster main thread: marshal into ours
        def record():
            self._results[job_id] = result
            if self.ha is not None and result.state == "FINISHED":
                self.ha.remove_job(job_id)
            if self.history_dir is not None:
                from flink_tpu_torch.rest.history import archive_job
                try:
                    status = await_future(self._jobs[job_id].job_status())
                except Exception:  # noqa: BLE001 — archive the bare result
                    status = {"state": result.state,
                              "error": getattr(result, "error", None)}
                archive_job(self.history_dir, job_id, status)
        self.run_async(record)

    def list_jobs(self) -> List[str]:
        self.validate_runs_in_main_thread()
        return sorted(self._jobs)

    def job_status(self, job_id: str) -> Dict[str, Any]:
        self.validate_runs_in_main_thread()
        gw = self._jobs.get(job_id)
        if gw is None:
            raise KeyError(job_id)
        return await_future(gw.job_status())

    def cancel_job(self, job_id: str) -> str:
        self.validate_runs_in_main_thread()
        return await_future(self._jobs[job_id].cancel())

    def trigger_savepoint(self, job_id: str) -> Optional[int]:
        self.validate_runs_in_main_thread()
        return await_future(self._jobs[job_id].trigger_savepoint())

    def result_of(self, job_id: str):
        self.validate_runs_in_main_thread()
        return self._results.get(job_id)


# ---------------------------------------------------------------------------
# session cluster assembly + client
# ---------------------------------------------------------------------------

class StandaloneSessionCluster:
    """``StandaloneSessionClusterEntrypoint`` analog: RM + Dispatcher + N
    TaskExecutors on one RpcService; optional HA + checkpoint storage."""

    def __init__(self, num_task_executors: int = 1, slots_per_executor: int = 1,
                 ha_services=None,
                 checkpoint_storage_factory: Optional[Callable[[str], Any]] = None,
                 plan_builder: Optional[Callable[[Any], Any]] = None,
                 history_dir: Optional[str] = None):
        self.rpc = RpcService()
        self.rm = ResourceManagerEndpoint(self.rpc)
        self.rm_gw = self.rpc.start_endpoint(self.rm)
        self.task_executors = []
        for i in range(num_task_executors):
            te = TaskExecutorEndpoint(f"taskexecutor-{i}", slots_per_executor)
            self.rpc.start_endpoint(te)
            await_future(self.rm_gw.register_task_executor(te.name))
            self.task_executors.append(te)
        self.dispatcher = DispatcherEndpoint(
            self.rpc, self.rm.name, ha_services=ha_services,
            checkpoint_storage_factory=checkpoint_storage_factory,
            plan_builder=plan_builder, history_dir=history_dir)
        self.dispatcher_gw = self.rpc.start_endpoint(self.dispatcher)

    def client(self) -> "ClusterClient":
        return ClusterClient(self.dispatcher_gw, self.rm_gw)

    def shutdown(self) -> None:
        self.rpc.stop()


class ClusterClient:
    """``RestClusterClient``/CLI-facing client."""

    def __init__(self, dispatcher_gw, rm_gw):
        self._dispatcher = dispatcher_gw
        self._rm = rm_gw

    def submit(self, plan, parallelism: int = 1,
               checkpoint_interval_ms: int = 0, job_spec: Any = None) -> str:
        return await_future(self._dispatcher.submit_job(
            plan, parallelism, checkpoint_interval_ms, job_spec))

    def list_jobs(self) -> List[str]:
        return await_future(self._dispatcher.list_jobs())

    def status(self, job_id: str) -> Dict[str, Any]:
        return await_future(self._dispatcher.job_status(job_id))

    def cancel(self, job_id: str) -> str:
        return await_future(self._dispatcher.cancel_job(job_id))

    def savepoint(self, job_id: str) -> Optional[int]:
        return await_future(self._dispatcher.trigger_savepoint(job_id))

    def overview(self) -> Dict[str, int]:
        return await_future(self._rm.overview())

    def wait_for_completion(self, job_id: str, timeout_s: float = 300.0):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            res = await_future(self._dispatcher.result_of(job_id))
            if res is not None:
                return res
            st = self.status(job_id)
            if st["status"] in ("FAILED", "CANCELED"):
                time.sleep(0.05)
                return await_future(self._dispatcher.result_of(job_id))
            time.sleep(0.02)
        raise TimeoutError(f"job {job_id} did not complete in {timeout_s}s")

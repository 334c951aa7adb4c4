"""Cross-process cluster: coordinator + TaskExecutor worker processes
(port of ``flink_tpu/cluster/distributed.py``, host Python as JAX's).

The multi-process analog of the reference's Dispatcher/JobMaster ↔
TaskExecutor deployment (``Execution.deploy`` →
``TaskExecutor.submitTask:554`` over RPC): a :class:`ProcessCluster`
coordinator spawns N worker processes, each hosting a deterministic slice of
the job's subtasks.  Data-plane edges whose endpoints live in different
processes ride the TCP credit-controlled channels of ``cluster/net.py`` (the
Netty-shuffle analog); same-process edges stay in-memory ``LocalChannel``s —
exactly the reference's local-vs-remote input channel split
(``LocalInputChannel`` / ``RemoteInputChannel``).

**Job shipping** follows the jar model (BLOB service analog): the job is a
``module:function`` reference returning a ``StreamExecutionEnvironment`` (or
``ExecutionPlan``); every process imports it and rebuilds the SAME plan, then
instantiates only its assigned subtasks.  This requires the builder to be
deterministic (source split creation included) — the same property a
reference job jar must have for task deployment to be consistent.

**Control plane** is a length-prefixed pickle protocol over one TCP
connection per worker (the Akka RPC analog, single coordinator thread per
worker connection):

  worker → coordinator: ``hello`` (data-plane address), ``state`` (task
  transitions), ``ack`` (checkpoint snapshots), ``final`` (FLIP-147 final
  snapshots of finished tasks), ``rows`` (collect-sink results),
  ``worker_done``
  coordinator → worker: ``deploy`` (address map + restore), ``checkpoint``
  (source barrier injection, ``CheckpointCoordinator.triggerCheckpoint``
  analog), ``notify`` (checkpoint complete), ``stop``

Checkpoints run the same protocol as the in-process MiniCluster: the
coordinator triggers sources, barriers flow in-band through local AND remote
channels, every subtask acks with its snapshot, and the coordinator
assembles + stores the completed checkpoint (restorable at a different
worker count — the assignment is re-computed, state is per-subtask).

**The device.** Every worker is a fresh interpreter with its own CUDA
context.  The coordinator resolves its device once
(:func:`flink_tpu_torch.resolve_device`, the card unless the caller names
one) and ships it on each spawned worker's command line (``--device``); a
worker sets it as its process device, so its environments and operators
that name no device take it, and a worker told ``cuda`` that sees no card
raises at start: the attempt fails, nothing falls back to the CPU.
Workers started by hand (``coordinate`` with ``spawn=False``) each take
their own ``--device``.

The queryable serving tier comes with ROADMAP Queue A item 10: its entry
points here raise naming the item, as the MiniCluster's do.
"""

from __future__ import annotations

import importlib
import json
import os
import pickle
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from flink_tpu_torch import DeviceLike, resolve_device, set_process_device
from flink_tpu_torch.cluster.minicluster import _later_queryable

_LEN = struct.Struct("<I")

#: handshake frames must never exceed this — a pre-auth peer cannot make
#: the coordinator buffer arbitrary amounts
_MAX_HANDSHAKE = 4096

#: coordinator HA: every coordinator→worker control message
#: carries the leader epoch as its LAST element; this table maps each
#: message kind to its base arity so workers can pop the epoch off
#: regardless of the kind's own optional fields.  Epoch 0 = HA off.
_MSG_ARITY = {"deploy": 6, "checkpoint": 2, "notify": 2, "split_assign": 5,
              "reset": 1, "reset_tasks": 2, "trace_request": 1,
              "cancel": 1, "stop": 1, "ping": 1}

#: leader epochs partition the checkpoint-id space: epoch e's coordinator
#: numbers its checkpoints from ``(e-1) * stride + 1``, so a zombie
#: ex-leader racing the new leader into a SHARED checkpoint directory can
#: never collide with (or overwrite) the new incarnation's cuts — the
#: cross-incarnation id fencing the autoscaler introduced, scaled to
#: leader changes
_CID_EPOCH_STRIDE = 1_000_000


def _recv_raw(sock: socket.socket, limit: Optional[int] = None
              ) -> Optional[bytes]:
    buf = b""
    while len(buf) < _LEN.size:
        chunk = sock.recv(_LEN.size - len(buf))
        if not chunk:
            return None
        buf += chunk
    (n,) = _LEN.unpack(buf)
    if limit is not None and n > limit:
        return None
    data = b""
    while len(data) < n:
        chunk = sock.recv(min(1 << 20, n - len(data)))
        if not chunk:
            return None
        data += chunk
    return data


def _send_msg(sock: socket.socket, obj: Any, lock: threading.Lock) -> None:
    data = pickle.dumps(obj)
    with lock:
        sock.sendall(_LEN.pack(len(data)) + data)


def _recv_msg(sock: socket.socket) -> Optional[Any]:
    """Post-handshake control message (pickle).  Only ever called on a
    connection whose peer already passed the JSON hello/challenge exchange
    (and its HMAC, when the cluster has a token) — an unauthenticated peer
    never reaches a ``pickle.loads``."""
    data = _recv_raw(sock)
    return None if data is None else pickle.loads(data)


def _send_json(sock: socket.socket, obj: Any, lock: threading.Lock) -> None:
    """Handshake frame: length-prefixed JSON — non-executable by design, so
    both ends can parse the peer's FIRST message before trusting it."""
    data = json.dumps(obj).encode()
    with lock:
        sock.sendall(_LEN.pack(len(data)) + data)


def _recv_json(sock: socket.socket) -> Optional[Any]:
    data = _recv_raw(sock, limit=_MAX_HANDSHAKE)
    if data is None:
        return None
    try:
        return json.loads(data)
    except (ValueError, UnicodeDecodeError):
        return None


def _require_secure_bind(bind_host: str, security, role: str) -> None:
    """Shared bind policy (``cluster.net.require_secure_bind``) applied to a
    :class:`SecurityConfig`."""
    from flink_tpu_torch.cluster.net import require_secure_bind

    has_tls = security is not None and security.internal_ssl
    require_secure_bind(bind_host, has_tls, role)


def build_plan(job: str):
    """``module:function`` → ExecutionPlan (the jar-main analog)."""
    mod_name, fn_name = job.rsplit(":", 1)
    obj = getattr(importlib.import_module(mod_name), fn_name)()
    if hasattr(obj, "to_plan"):
        return obj.to_plan()
    if hasattr(obj, "get_stream_graph"):
        return obj.get_stream_graph(job).to_plan()
    return obj  # already an ExecutionPlan


def plan_structure_digest(plan) -> str:
    """Stable fingerprint of a plan's deploy-relevant STRUCTURE: vertex
    uids/names/parallelisms, subtask counts (source split counts included),
    and edges with partitioning/key columns.

    Job shipping rebuilds the plan in every process from the
    ``module:function`` reference, which silently assumes the builder is
    deterministic; a nondeterministic builder (unseeded shuffles, dict-order
    uids, host-dependent split enumeration) makes workers deploy DIFFERENT
    jobs and diverge without any error.  The coordinator ships this digest
    with every deploy and workers verify their own rebuild against it —
    mismatches fail fast at deploy instead of corrupting the run."""
    import hashlib

    counts, _splits = subtask_counts_of(plan)
    parts = []
    for v in plan.vertices:
        parts.append(f"v:{v.uid}:{v.name}:{counts.get(v.uid)}:"
                     f"{v.max_parallelism}:{int(bool(v.is_source))}")
        for e in v.out_edges:
            tgt = plan.by_id[e.target_id]
            parts.append(f"e:{v.uid}->{tgt.uid}"
                         f"#{getattr(e, 'input_index', 0)}:"
                         f"{getattr(e, 'partitioning', None)}:"
                         f"{getattr(e, 'key_column', None)}")
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()[:16]


def subtask_counts_of(plan) -> Tuple[Dict[str, int], Dict[int, list]]:
    """Subtask count per vertex (sources: one per split, like the
    MiniCluster; runtime-enumerated sources: fixed reader count, splits
    assigned over the control plane) and the static split lists."""
    counts: Dict[str, int] = {}
    splits_by_vertex: Dict[int, list] = {}
    for v in plan.vertices:
        if v.is_source:
            src = v.chain[0].source
            if getattr(src, "create_enumerator", None) is not None:
                splits_by_vertex[v.id] = None  # dynamic: request at runtime
                counts[v.uid] = v.parallelism
                continue
            splits = src.create_splits(v.parallelism)
            splits_by_vertex[v.id] = splits
            counts[v.uid] = max(1, len(splits))
        else:
            counts[v.uid] = v.parallelism
    return counts, splits_by_vertex


def assign_subtasks(plan, counts: Dict[str, int],
                    n_workers: int) -> Dict[Tuple[str, int], int]:
    """Deterministic subtask → worker placement (round-robin over the
    plan's vertex order — the declarative SlotManager's match, made a pure
    function of (plan, n) so every process computes it identically)."""
    out: Dict[Tuple[str, int], int] = {}
    i = 0
    for v in plan.vertices:
        for s in range(counts[v.uid]):
            out[(v.uid, s)] = i % n_workers
            i += 1
    return out


def _edge_pairs(part: str, np_: int, nc: int):
    """(producer, consumer, effective_partitioning) tuples for one edge —
    the same channel topology the MiniCluster builds."""
    if part == "forward" and np_ == nc:
        return [(pi, pi) for pi in range(np_)], "forward"
    eff = "rebalance" if (part == "forward" and nc > 1) else part
    return [(pi, ci) for pi in range(np_) for ci in range(nc)], eff


# --------------------------------------------------------------------------
# worker process
# --------------------------------------------------------------------------

def _security_from_env() -> Optional["SecurityConfig"]:
    """Worker-side security settings, shipped via environment variables by
    the coordinator (the reference ships keystores via the container env /
    mounted secrets the same way)."""
    from flink_tpu_torch.security import SecurityConfig

    cert = os.environ.get("FLINK_TPU_SSL_CERT")
    token = os.environ.get("FLINK_TPU_AUTH_TOKEN")
    if not cert and not token:
        return None
    return SecurityConfig(
        internal_ssl=bool(cert),
        cert_path=cert,
        key_path=os.environ.get("FLINK_TPU_SSL_KEY"),
        ca_path=os.environ.get("FLINK_TPU_SSL_CA"),
        auth_token=token or None)


class _WorkerRuntime:
    """TaskListener inside a worker: deploys the local subtask slice and
    relays task events to the coordinator."""

    def __init__(self, index: int, n_workers: int, job: str,
                 coord_host: str, coord_port: int,
                 bind_host: str = "127.0.0.1",
                 advertise_host: Optional[str] = None,
                 local_recovery_dir: Optional[str] = None,
                 device: DeviceLike = None):
        from flink_tpu_torch.cluster.net import ChannelServer

        #: this process's device (the coordinator's ``--device``): what
        #: an environment or operator that names none resolves to here;
        #: ``cuda`` without a card raises before the worker says hello
        self.device = set_process_device(device)

        #: checkpoint-policy options shipped with deploy (unaligned /
        #: alignment-timeout escalation / alignment-queue cap) plus the
        #: observability opts (tracing / latency-marker cadence)
        self._ckpt_opts: Dict[str, Any] = {}
        #: per-(source, hop) latency histograms for THIS worker's hops;
        #: shipped to the coordinator with the trace dump
        self.latency_tracker = None

        #: local recovery (TaskLocalStateStoreImpl.java:54): secondary
        #: worker-local snapshot copies; restore prefers them over the
        #: coordinator-shipped (remote-storage) state
        self.local_store = None
        #: run scoping: only checkpoints of THIS cluster run restore from
        #: the local store (ids restart per run; a reused dir must not
        #: serve a previous run's chk-N files)
        self.run_token = os.environ.get("FLINK_TPU_RUN_TOKEN")
        if local_recovery_dir is None:
            local_recovery_dir = os.environ.get("FLINK_TPU_LOCAL_RECOVERY")
        if local_recovery_dir:
            from flink_tpu_torch.runtime.checkpoint.local import TaskLocalStateStore
            scoped = (os.path.join(local_recovery_dir,
                                   f"run-{self.run_token}")
                      if self.run_token else local_recovery_dir)
            self.local_store = TaskLocalStateStore(scoped, index)
        #: per-deploy counters, reported to the coordinator after each
        #: restore so tests (and operators) can assert local-recovery hits
        self.recovery_local = 0
        self.recovery_remote = 0
        self.index = index
        self.n_workers = n_workers
        self.job = job
        self.security = _security_from_env()
        server_ctx = client_ctx = None
        if self.security is not None and self.security.internal_ssl:
            server_ctx = self.security.server_context()
            client_ctx = self.security.client_context()
        self._client_ssl = client_ctx
        #: data-plane HMAC: channel HELLOs are signed with the cluster
        #: token, so worker ports never decode unauthenticated batches
        self._data_token = (self.security.auth_token
                            if self.security is not None else None)
        self.server = ChannelServer(host=bind_host, ssl_context=server_ctx,
                                    auth_token=self._data_token)
        #: address other workers dial (pod IP / service DNS on k8s)
        self.advertise_host = advertise_host or self.server.host
        self.sock = socket.create_connection((coord_host, coord_port),
                                             timeout=30)
        if client_ctx is not None:
            self.sock = client_ctx.wrap_socket(self.sock,
                                               server_hostname=coord_host)
        # the connect timeout must not linger: the worker blocks on this
        # socket indefinitely waiting for deploy/stop (sibling workers can
        # take arbitrarily long to cold-start before the coordinator
        # broadcasts deploy)
        self.sock.settimeout(None)
        self._send_lock = threading.Lock()
        self._lock = threading.Lock()
        self.tasks: List[Any] = []
        self._terminal = set()
        self._done_sent = False
        self._remote_writers: List[Any] = []
        self._split_queues: Dict[Tuple[str, int], Any] = {}
        #: region-scoped recovery bookkeeping: which remote writers a local
        #: producer owns, and which server channel ids feed a local consumer
        self._writers_by_task: Dict[Tuple[str, int], List[Any]] = {}
        self._inchans_by_task: Dict[Tuple[str, int], List[str]] = {}
        #: coordinator HA: highest leader epoch observed on the
        #: control plane — messages carrying a LOWER (non-zero) epoch are a
        #: zombie ex-leader's and are rejected, never acted on
        self._leader_epoch = 0
        self._fenced_msgs = 0
        #: orphan-worker reaper: tracks coordinator liveness through the
        #: shared heartbeat seam; armed at deploy when the coordinator
        #: ships an ``orphan_timeout_s`` (None until then)
        self._hb = None
        self.orphaned = False

    # -- coordinator HA -----------------------------------------------------
    def _admit_epoch(self, epoch: int, kind: str) -> bool:
        """Leader-epoch fence: adopt a HIGHER epoch (a new leader took
        over), reject a LOWER one (a zombie ex-leader still sending).
        Epoch 0 means HA is off and everything is admitted."""
        if epoch > self._leader_epoch:
            self._leader_epoch = epoch
            server = getattr(self, "server", None)
            if server is not None and hasattr(server, "min_epoch"):
                # fence the data plane too: a stale incarnation's remote
                # writers fail the channel HELLO against this worker
                server.min_epoch = epoch
            return True
        if epoch and epoch < self._leader_epoch:
            self._fenced_msgs += 1
            self._send(("fenced", self.index, kind, epoch))
            return False
        return True

    def _arm_orphan_reaper(self, timeout_s: float) -> None:
        """Satellite 1: self-terminate (committing nothing) when the lease
        holder goes silent past ``timeout_s`` — a dead-but-unreaped
        coordinator must not leak worker processes holding sockets and
        device state forever.  Every control message (pings included)
        counts as a heartbeat."""
        if self._hb is not None:
            return
        from flink_tpu_torch.cluster.heartbeat import (HeartbeatManager,
                                                       HeartbeatTarget)
        self._hb = HeartbeatManager(
            interval_s=max(0.2, float(timeout_s) / 4.0),
            timeout_s=float(timeout_s),
            on_timeout=self._coordinator_silent)
        # the coordinator PUSHES pings; the request side is a no-op
        self._hb.monitor_target("coordinator",
                                HeartbeatTarget(lambda: None))
        self._hb.receive_heartbeat("coordinator")
        self._hb.start()

    def _coordinator_silent(self, resource_id: str) -> None:
        self.orphaned = True
        for t in self.tasks:
            t.cancel()
        try:
            # unblocks the control loop's recv -> clean exit path; nothing
            # is committed (commits only ever happen on notify-complete).
            # A close alone does not wake a recv blocked in another
            # thread: shut the socket down first
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass

    def _send(self, obj: Any) -> None:
        try:
            _send_msg(self.sock, obj, self._send_lock)
        except OSError:
            pass

    # -- TaskListener ------------------------------------------------------
    def task_state_changed(self, vertex_uid: str, subtask_index: int,
                           state: str, error: Optional[str]) -> None:
        self._send(("state", vertex_uid, subtask_index, state, error))
        if state == "FINISHED":
            t = next((t for t in self.tasks
                      if t.vertex_uid == vertex_uid
                      and t.subtask_index == subtask_index), None)
            final = getattr(t, "final_snapshot", None) if t else None
            if final is not None:
                self._send(("final", vertex_uid, subtask_index, final))
        if state in ("FINISHED", "CANCELED", "FAILED"):
            with self._lock:
                self._terminal.add((vertex_uid, subtask_index))
                done = (len(self._terminal) >= len(self.tasks)
                        and not self._done_sent)
                if done:
                    self._done_sent = True
            if done:
                self._collect_and_finish()

    def acknowledge_checkpoint(self, checkpoint_id: int, vertex_uid: str,
                               subtask_index: int,
                               snapshot: Dict[str, Any]) -> None:
        if self.local_store is not None:
            # secondary local copy BEFORE the ack ships: a same-worker
            # restart restores from here without touching remote storage
            self.local_store.store(checkpoint_id, vertex_uid,
                                   subtask_index, snapshot)
        self._send(("ack", checkpoint_id, vertex_uid, subtask_index,
                    snapshot, self._leader_epoch))

    def decline_checkpoint(self, checkpoint_id: int, vertex_uid: str,
                           subtask_index: int, error: str) -> None:
        """A subtask's snapshot failed: ship the decline to the coordinator
        (``declineCheckpoint`` RPC) so the pending checkpoint is aborted and
        charged to the failure budget — the task itself keeps running."""
        self._send(("decline", checkpoint_id, vertex_uid, subtask_index,
                    error))

    # -- runtime split requests (FLIP-27 RequestSplitEvent over the
    # control plane; replies land on a per-reader queue) ------------------
    def _make_split_requester(self, uid: str, idx: int):
        import queue as _q

        q: "_q.Queue" = _q.Queue()
        self._split_queues[(uid, idx)] = q

        def request():
            self._send(("split_request", uid, idx))
            try:
                split, done = q.get(timeout=60)
            except _q.Empty:
                # a silent finish here would report FINISHED with unread
                # files; failing the task triggers restart + restore instead
                raise RuntimeError(
                    "split request timed out — coordinator unreachable")
            return split, done
        return request

    # -- results -----------------------------------------------------------
    def _collect_and_finish(self) -> None:
        from flink_tpu_torch.connectors.sinks import CollectSink
        from flink_tpu_torch.operators.basic import SinkOperator

        for t in self.tasks:
            ops = getattr(t.operator, "operators", [t.operator])
            for op in ops:
                sink = getattr(op, "sink", None)
                if isinstance(op, SinkOperator) and isinstance(sink,
                                                               CollectSink):
                    self._send(("rows", t.vertex_uid, t.subtask_index,
                                sink.rows()))
        self._send(("worker_done", self.index))

    # -- deploy ------------------------------------------------------------
    def deploy(self, addresses: Dict[int, Tuple[str, int]],
               restore: Optional[Dict[str, Any]],
               only: Optional[set] = None,
               expected_digest: Optional[str] = None,
               ckpt_opts: Optional[Dict[str, Any]] = None) -> bool:
        """Build and start this worker's subtask slice.  ``only``: restrict
        to these (vertex_uid, subtask_index) — region-scoped recovery
        redeploys just the affected regions' tasks, leaving the rest
        running (``RestartPipelinedRegionFailoverStrategy``).  Regions are
        edge-closed, so every channel of an ``only`` task has both
        endpoints inside ``only``.

        ``expected_digest``: the coordinator's plan-structure digest.  This
        worker rebuilds the plan from the job reference and REFUSES to
        deploy on mismatch (nondeterministic job builder) — failing fast
        beats silently deploying a divergent job.  Returns False on the
        refusal."""
        from flink_tpu_torch.cluster.channels import LocalChannel, OutputDispatcher
        from flink_tpu_torch.cluster.net import RemoteChannel
        from flink_tpu_torch.cluster.task import SourceSubtask, Subtask
        from flink_tpu_torch.core.functions import RuntimeContext

        plan = build_plan(self.job)
        if expected_digest is not None:
            local = plan_structure_digest(plan)
            if local != expected_digest:
                self._send(("plan_mismatch", self.index, local,
                            expected_digest))
                return False
        if ckpt_opts is not None:
            self._ckpt_opts = dict(ckpt_opts)
        opts = self._ckpt_opts
        if opts.get("orphan_timeout_s"):
            self._arm_orphan_reaper(opts["orphan_timeout_s"])
        # observability: install the span journal when the coordinator
        # asked for tracing, and stand up the per-worker latency tracker
        # (markers record at every local hop; the panel ships with the
        # trace dump for cross-process assembly)
        if opts.get("tracing"):
            from flink_tpu_torch.observability import tracing as tracing_mod
            if not tracing_mod.enabled():
                tracing_mod.install(
                    capacity=int(opts.get("trace_capacity", 65536)))
        if self.latency_tracker is None:
            from flink_tpu_torch.observability import LatencyTracker
            self.latency_tracker = LatencyTracker()
        counts, splits_by_vertex = subtask_counts_of(plan)
        assign = assign_subtasks(plan, counts, self.n_workers)
        me = self.index

        def n_subs(v) -> int:
            return counts[v.uid]

        def wanted(uid: str, i: int) -> bool:
            return only is None or (uid, i) in only

        inputs: Dict[int, List[List[Any]]] = {
            v.id: [[] for _ in range(n_subs(v))] for v in plan.vertices}
        input_logical: Dict[int, List[List[int]]] = {
            v.id: [[] for _ in range(n_subs(v))] for v in plan.vertices}
        # per-input-channel routing metadata written into the v2
        # channel-state section (rescale restores re-route persisted
        # in-flight elements by record key — state/redistribute)
        input_routing: Dict[int, List[List[Dict[str, Any]]]] = {
            v.id: [[] for _ in range(n_subs(v))] for v in plan.vertices}
        outputs: Dict[int, List[List[OutputDispatcher]]] = {
            v.id: [[] for _ in range(n_subs(v))] for v in plan.vertices}

        for v in plan.vertices:
            for ei, e in enumerate(v.out_edges):
                tgt = plan.by_id[e.target_id]
                np_, nc = n_subs(v), n_subs(tgt)
                pairs, eff = _edge_pairs(e.partitioning, np_, nc)
                routing = {"partitioning": e.partitioning,
                           "key_column": e.key_column,
                           "max_parallelism": v.max_parallelism,
                           "logical": e.input_index}
                # group channels per producer (dispatcher wants ci order)
                per_producer: Dict[int, List[Any]] = {}
                for pi, ci in pairs:
                    if not (wanted(v.uid, pi) or wanted(tgt.uid, ci)):
                        continue
                    p_local = assign[(v.uid, pi)] == me
                    c_local = assign[(tgt.uid, ci)] == me
                    chan_id = f"{v.uid}[{pi}]->{tgt.uid}[{ci}]#{ei}"
                    ch = None
                    if p_local and c_local:
                        ch = LocalChannel(name=chan_id)
                        inputs[tgt.id][ci].append(ch)
                        input_logical[tgt.id][ci].append(e.input_index)
                        input_routing[tgt.id][ci].append(dict(routing))
                    elif p_local:
                        host, port = addresses[assign[(tgt.uid, ci)]]
                        ch = RemoteChannel(host, port, chan_id,
                                           ssl_context=self._client_ssl,
                                           auth_token=self._data_token,
                                           epoch=self._leader_epoch)
                        self._remote_writers.append(ch)
                        self._writers_by_task.setdefault(
                            (v.uid, pi), []).append(ch)
                    elif c_local:
                        q = self.server.channel(chan_id)
                        inputs[tgt.id][ci].append(q)
                        input_logical[tgt.id][ci].append(e.input_index)
                        input_routing[tgt.id][ci].append(dict(routing))
                        self._inchans_by_task.setdefault(
                            (tgt.uid, ci), []).append(chan_id)
                    if p_local:
                        per_producer.setdefault(pi, []).append(ch)
                for pi, chans in per_producer.items():
                    outputs[v.id][pi].append(OutputDispatcher(
                        eff, chans, max_parallelism=v.max_parallelism,
                        subtask_index=pi, key_column=e.key_column))

        # build EVERY local task first, then start: a fast task finishing
        # while deploy is mid-flight must not trip the all-terminal check
        # against a partial task list
        restore = restore or {}
        job_meta = restore.get("__job__") or {}
        restore_cid = job_meta.get("checkpoint_id")
        # the local store only serves checkpoints taken by THIS run: a
        # cross-run restore (snap passed into a fresh cluster) carries a
        # different run token and must read the shipped state
        same_run = (self.run_token is not None
                    and job_meta.get("run_token") == self.run_token)
        self.recovery_local = 0
        self.recovery_remote = 0

        def pick_restore(uid: str, i: int, sub_snaps) -> Optional[Dict]:
            """Local-recovery preference: this worker's own local copy of
            (checkpoint, uid, subtask) wins over the coordinator-shipped
            remote state; the shipped copy is the fallback."""
            from flink_tpu_torch.testing import chaos
            shipped = sub_snaps[i] if i < len(sub_snaps) else None
            if self.local_store is not None and restore_cid is not None \
                    and same_run:
                local = self.local_store.load(restore_cid, uid, i)
                if local is not None:
                    self.recovery_local += 1
                    return local
                if shipped is not None:
                    self.recovery_remote += 1
            if shipped is not None and not chaos.fire(
                    "restore.fetch", direction="storage->worker",
                    worker=self.index, uid=uid, subtask=i):
                # Partition(direction="storage->worker"): the remote
                # (primary-storage) copy is unreachable — fail the deploy
                # loudly rather than silently restoring empty state
                raise RuntimeError(
                    f"restore fetch partitioned (storage->worker) for "
                    f"{uid}[{i}] and no local copy available")
            return shipped

        to_start: List[Tuple[Any, Optional[Dict[str, Any]]]] = []
        for v in plan.vertices:
            vr = restore.get(v.uid, {})
            sub_snaps = vr.get("subtasks", [])
            if v.is_source:
                splits = splits_by_vertex[v.id]
                if splits is None:
                    # runtime enumeration: every reader pulls splits from
                    # the coordinator over the control plane (the
                    # RequestSplitEvent RPC, SourceCoordinator.java:155)
                    for i in range(counts[v.uid]):
                        if assign[(v.uid, i)] != me or not wanted(v.uid, i):
                            continue
                        ctx = RuntimeContext(
                            task_name=v.name, subtask_index=i,
                            parallelism=counts[v.uid],
                            max_parallelism=v.max_parallelism)
                        t = SourceSubtask(
                            v.uid, i, v.build_operator(),
                            outputs[v.id][i], ctx, self, None,
                            split_requester=self._make_split_requester(
                                v.uid, i))
                        to_start.append((t, pick_restore(v.uid, i,
                                                         sub_snaps)))
                    continue
                for i, split in enumerate(splits):
                    if assign[(v.uid, i)] != me or not wanted(v.uid, i):
                        continue
                    ctx = RuntimeContext(task_name=v.name, subtask_index=i,
                                         parallelism=len(splits),
                                         max_parallelism=v.max_parallelism)
                    t = SourceSubtask(v.uid, i, v.build_operator(),
                                      outputs[v.id][i], ctx, self, split)
                    to_start.append((t, pick_restore(v.uid, i, sub_snaps)))
            else:
                for i in range(n_subs(v)):
                    if assign[(v.uid, i)] != me or not wanted(v.uid, i):
                        continue
                    ctx = RuntimeContext(task_name=v.name, subtask_index=i,
                                         parallelism=n_subs(v),
                                         max_parallelism=v.max_parallelism)
                    t = Subtask(v.uid, i, v.build_operator(),
                                outputs[v.id][i], ctx, self,
                                inputs[v.id][i],
                                input_logical=input_logical[v.id][i],
                                unaligned=opts.get("unaligned", False),
                                alignment_timeout_ms=opts.get(
                                    "alignment_timeout_ms"),
                                alignment_queue_max=opts.get(
                                    "alignment_queue_max", 8192),
                                input_routing=input_routing[v.id][i])
                    to_start.append((t, pick_restore(v.uid, i, sub_snaps)))
        if only is None:
            self.tasks = [t for t, _ in to_start]
        else:
            self.tasks.extend(t for t, _ in to_start)
            with self._lock:
                # re-arm completion reporting (reset_tasks suppressed it);
                # the just-started tasks guarantee a future terminal
                # transition that runs the done check
                self._done_sent = False
        # incremental checkpoints: flip delta-tracking on in
        # every capable operator/backend of this worker's slice (mirror of
        # MiniCluster._attach_observability's incremental wiring)
        if opts.get("incremental"):
            for t, _snap in to_start:
                t.incremental_checkpoints = True
                for member in getattr(t.operator, "operators", [t.operator]):
                    if hasattr(member, "incremental_state"):
                        member.incremental_state = True
                        if hasattr(member, "incr_rebase_ratio"):
                            member.incr_rebase_ratio = float(
                                opts.get("incr_rebase_ratio", 0.5))
                        be = getattr(member, "backend", None)
                        if be is not None \
                                and hasattr(be, "snapshot_increment"):
                            be.materialize_threshold = int(
                                opts.get("materialization_threshold", 256))
        lat_ms = int(opts.get("latency_interval_ms") or 0)
        # worker-local deploy barrier (the MiniCluster one, scoped to this
        # process's slice): shared-instance sinks restore by replacement,
        # so no local subtask may process input before the slice restored
        gate = (threading.Barrier(len(to_start)) if len(to_start) > 1
                else None)
        for t, snap in to_start:
            t.latency_tracker = self.latency_tracker
            t._deploy_gate = gate
            if lat_ms and isinstance(t, SourceSubtask):
                t.latency_marker_interval_ms = lat_ms
            t.start(snap)
        if opts.get("queryable_serving", True):
            self._wire_worker_queryable()
        if not self.tasks:
            self._done_sent = True
            self._send(("worker_done", self.index))
        return True

    def _wire_worker_queryable(self) -> None:
        """The per-worker serving tier's registration of this worker's
        ``queryable=<name>`` views: it comes with ROADMAP Queue A item 10,
        so a deployed operator that publishes a view raises here."""
        for t in self.tasks:
            op = getattr(t, "operator", None)
            for member in getattr(op, "operators", [op]):
                if getattr(member, "queryable", None) is not None:
                    raise _later_queryable()

    # -- main loop ---------------------------------------------------------
    def run(self) -> int:
        # auth handshake, JSON both ways (never pickle pre-auth): the
        # coordinator challenges, the worker answers with an HMAC over the
        # nonce (cluster shared secret)
        msg = _recv_json(self.sock)
        if not isinstance(msg, dict) or msg.get("kind") != "challenge":
            return 1
        nonce_hex = msg.get("nonce")
        mac_hex = None
        if nonce_hex is not None:
            if self.security is None or self.security.auth_token is None:
                return 1  # cluster requires a token this worker lacks
            try:
                nonce = bytes.fromhex(nonce_hex)
            except (TypeError, ValueError):
                return 1  # malformed challenge
            mac_hex = self.security.sign(nonce).hex()
        _send_json(self.sock, {"kind": "hello", "index": self.index,
                               "host": self.advertise_host,
                               "port": self.server.port, "mac": mac_hex},
                   self._send_lock)
        while True:
            msg = _recv_msg(self.sock)
            if msg is None:
                break
            kind = msg[0]
            # any control traffic proves the coordinator alive — heartbeat
            # BEFORE the epoch fence (a fenced zombie is still a liveness
            # signal only for ITS OWN workers, which share its socket)
            if self._hb is not None:
                self._hb.receive_heartbeat("coordinator")
            base = _MSG_ARITY.get(kind)
            epoch = 0
            if base is not None and len(msg) > base:
                epoch = msg[base] or 0
            if not self._admit_epoch(epoch, kind):
                continue
            if kind == "ping":
                continue
            if kind == "deploy":
                ok = self.deploy(msg[1], msg[2],
                                 only=set(msg[3]) if len(msg) > 3
                                 and msg[3] is not None else None,
                                 expected_digest=msg[4] if len(msg) > 4
                                 else None,
                                 ckpt_opts=msg[5] if len(msg) > 5
                                 else None)
                if ok and msg[2] and (self.recovery_local
                                      or self.recovery_remote):
                    self._send(("recovery_stats", self.index,
                                self.recovery_local,
                                self.recovery_remote))
            elif kind == "checkpoint":
                cid = msg[1]
                for t in self.tasks:
                    if hasattr(t, "split"):  # source: inject barrier
                        t.commands.put(("checkpoint", cid))
            elif kind == "notify":
                if self.local_store is not None:
                    self.local_store.confirm(msg[1])
                for t in self.tasks:
                    t.commands.put(("notify_complete", msg[1]))
            elif kind == "split_assign":
                uid, idx, split, done = msg[1:5]
                q = self._split_queues.get((uid, idx))
                if q is not None:
                    q.put((split, done))
            elif kind == "reset":
                # surviving-worker recovery: tear down THIS worker's tasks
                # and channels, keep the process (and its warm caches/data
                # plane address) alive for the next deploy
                with self._lock:
                    self._done_sent = True  # suppress worker_done/rows
                for w in self._remote_writers:
                    try:
                        w.close()          # unblocks producers first
                    except OSError:
                        pass
                self._remote_writers = []
                # poison split-request waits: a reader parked in q.get()
                # cannot see cancel(); (None, True) ends its loop cleanly
                for q in self._split_queues.values():
                    q.put((None, True))
                for t in self.tasks:
                    t.cancel()
                for t in self.tasks:
                    t.join(timeout_s=10)
                self.server.reset()
                self.tasks = []
                self._split_queues = {}
                self._writers_by_task = {}
                self._inchans_by_task = {}
                with self._lock:
                    self._terminal = set()
                    self._done_sent = False
                self._send(("reset_done", self.index))
            elif kind == "reset_tasks":
                # region-scoped recovery: tear down ONLY the affected
                # regions' local tasks and their channels; everything else
                # keeps running (surviving regions never restart)
                with self._lock:
                    # suppress worker_done until the follow-up deploy: the
                    # cancels below (and any unaffected task finishing in
                    # the window) must not make this worker look done
                    # while its affected tasks are pending redeploy
                    self._done_sent = True
                aff = set(msg[1])
                mine = [t for t in self.tasks
                        if (t.vertex_uid, t.subtask_index) in aff]
                for t in mine:
                    key = (t.vertex_uid, t.subtask_index)
                    for w in self._writers_by_task.pop(key, []):
                        try:
                            w.close()
                        except OSError:
                            pass
                        if w in self._remote_writers:
                            self._remote_writers.remove(w)
                    q = self._split_queues.pop(key, None)
                    if q is not None:
                        q.put((None, True))
                for t in mine:
                    t.cancel()
                for t in mine:
                    t.join(timeout_s=10)
                drop_chans = [cid for t in mine for cid in
                              self._inchans_by_task.pop(
                                  (t.vertex_uid, t.subtask_index), [])]
                self.server.reset_channels(drop_chans)
                self.tasks = [t for t in self.tasks if t not in mine]
                with self._lock:
                    self._terminal -= {(t.vertex_uid, t.subtask_index)
                                       for t in mine}
                    # _done_sent stays True: deploy(only=...) re-arms it
                self._send(("reset_done", self.index))
            elif kind == "trace_request":
                # ship this process's span ring + latency panel + our wall
                # reading (the coordinator's clock-offset estimation input)
                from flink_tpu_torch.observability import tracing as tracing_mod
                from flink_tpu_torch.utils import clock as _clock
                j = tracing_mod.active()
                self._send(("trace_dump", self.index, {
                    "journal": j.snapshot() if j is not None else None,
                    "latency": (self.latency_tracker.panel()
                                if self.latency_tracker is not None else []),
                    "wall_now_ms": _clock.now_ms()}))
            elif kind == "cancel":
                for t in self.tasks:
                    t.cancel()
            elif kind == "stop":
                break
        if self._hb is not None:
            self._hb.stop()
        for t in self.tasks:
            t.join(timeout_s=10)
        for w in self._remote_writers:
            w.close()
        self.server.stop()
        return 0


# --------------------------------------------------------------------------
# coordinator (worker processes enter via `python -m flink_tpu_torch worker`,
# which constructs a _WorkerRuntime directly — see __main__._cmd_worker)
# --------------------------------------------------------------------------

class _Pending:
    def __init__(self, cid: int, expected: set, enumerators=None):
        from flink_tpu_torch.utils.clock import MonotoneElapsed

        self.cid = cid
        self.expected = set(expected)
        self.acks: Dict[Tuple[str, int], Dict[str, Any]] = {}
        #: expiry through the injectable clock seam, clamped monotone —
        #: a ClockSkew backward step never un-expires a checkpoint
        self.timer = MonotoneElapsed()
        #: trigger-time perf reading — the trigger→complete trace span
        self.t0_ns = time.perf_counter_ns()
        #: enumerator snapshots taken at trigger time (§3.4 coordinator
        #: snapshots precede task triggers)
        self.enumerators = enumerators


class ProcessCluster:
    """Coordinator: spawns workers, drives deploy/checkpoint/shutdown, and
    assembles results (the Dispatcher + JobMaster + CheckpointCoordinator
    roles collapsed into one process for a single job)."""

    def __init__(self, job: str, n_workers: int = 2,
                 checkpoint_storage=None, checkpoint_interval_ms: int = 0,
                 extra_sys_path: Tuple[str, ...] = (), security=None,
                 spawn: bool = True, bind_host: str = "127.0.0.1",
                 listen_port: int = 0, restart_attempts: int = 0,
                 restart_delay_ms: int = 500, worker_recovery: bool = True,
                 local_recovery_dir: Optional[str] = None,
                 tolerable_failed_checkpoints: int = 0,
                 checkpoint_timeout_s: float = 60.0,
                 unaligned: bool = False,
                 alignment_timeout_ms: Optional[float] = None,
                 alignment_queue_max: int = 8192,
                 tracing: bool = False,
                 latency_interval_ms: Optional[int] = None,
                 trace_capacity: int = 65536,
                 queryable_serving: bool = True,
                 incremental: bool = False,
                 incremental_rebase_ratio: float = 0.5,
                 changelog_materialization_threshold: int = 256,
                 ha_store=None,
                 ha_lease_ttl_s: float = 2.0,
                 ha_job_id: Optional[str] = None,
                 worker_orphan_timeout_s: Optional[float] = 45.0,
                 ping_interval_s: float = 5.0,
                 device: DeviceLike = None):
        from flink_tpu_torch.observability import tracing as tracing_mod
        from flink_tpu_torch.runtime.checkpoint.failure import \
            CheckpointFailureManager

        self.job = job
        self.n_workers = n_workers
        #: the device every spawned worker runs on, resolved once here
        #: (the card unless the caller names one; raises without a card)
        #: and shipped on each worker's command line; workers that dial in
        #: (``spawn=False``) take their own ``--device``
        self.device = resolve_device(device) if spawn else None
        #: coordinator HA: a FileHaStore holding the leader
        #: lease (monotone epoch), the registered job, and the
        #: completed-checkpoint pointer.  None = HA off (epoch stays 0 and
        #: the fences are no-ops).
        self.ha_store = ha_store
        self.ha_lease_ttl_s = float(ha_lease_ttl_s)
        if ha_job_id is None and ha_store is not None:
            from flink_tpu_torch.runtime.ha import job_id_for
            ha_job_id = job_id_for(job)
        self.ha_job_id = ha_job_id
        self._epoch = 0
        self._lease = None
        self._renewer = None
        #: completions this (zombie) coordinator lost to the epoch fence —
        #: each one also charges the checkpoint failure budget, so a fenced
        #: ex-leader fails LOUDLY instead of running forever
        self.ha_fenced_completions = 0
        #: stale-epoch worker messages observed (`("fenced", ...)` reports
        #: plus acks/qserve rejected coordinator-side)
        self.fenced_worker_msgs = 0
        #: how the last HA restore was resolved ("ha-pointer" /
        #: "scan-fallback" / "none"), for the REST panel and tests
        self.ha_restore_source: Optional[str] = None
        #: orphan-worker reaper deadline shipped to workers via ckpt_opts;
        #: the coordinator broadcasts pings every ping_interval_s so a
        #: quiet-but-alive leader keeps its workers
        self.worker_orphan_timeout_s = worker_orphan_timeout_s
        self.ping_interval_s = float(ping_interval_s)
        #: unaligned-checkpoint + observability policy, shipped to every
        #: worker with the deploy message (workers thread it into their
        #: Subtasks / install their span journals)
        self.ckpt_opts = {"unaligned": unaligned,
                          "alignment_timeout_ms": alignment_timeout_ms,
                          "alignment_queue_max": alignment_queue_max,
                          "tracing": tracing,
                          "latency_interval_ms": latency_interval_ms,
                          "trace_capacity": trace_capacity,
                          # per-worker serving (item 10): a worker whose
                          # operators publish views refuses the deploy
                          "queryable_serving": queryable_serving,
                          # incremental checkpoints: workers flip
                          # delta-tracking on in their operators/backends;
                          # the coordinator resolves increment acks against
                          # the previous completed cut before anything
                          # downstream consumes them
                          "incremental": incremental,
                          "incr_rebase_ratio": incremental_rebase_ratio,
                          "materialization_threshold":
                              changelog_materialization_threshold,
                          # orphan-worker reaper:
                          # workers self-terminate when the coordinator is
                          # silent past this deadline (None disables)
                          "orphan_timeout_s": worker_orphan_timeout_s}
        #: end-to-end tracing: workers record spans locally; at job end
        #: the coordinator pulls every ring and assembles ONE merged
        #: timeline (result["trace"], also kept as self.last_trace)
        self.tracing = tracing
        #: THIS cluster's coordinator-side journal handle (None when
        #: tracing is off): run() resets it per execution so job B never
        #: inherits job A's spans or its consumed ring capacity.  An
        #: adopted pre-existing journal belongs to whoever installed it —
        #: we record into it but never reset() it, and its owner's
        #: capacity choice wins over ``trace_capacity``
        self._trace_journal = None
        self._owns_trace_journal = False
        if tracing:
            self._trace_journal, self._owns_trace_journal = \
                tracing_mod.adopt_or_install(trace_capacity)
        self.last_trace: Optional[Dict[str, Any]] = None
        self._trace_cv = threading.Condition()
        self._trace_dumps: List[Tuple[int, Dict[str, Any], float]] = []
        #: per-checkpoint stats incl. alignment/overtaken/persisted
        #: in-flight accounting aggregated from the subtasks' acks
        self._checkpoint_stats: List[Dict[str, Any]] = []
        self.checkpoint_storage = checkpoint_storage
        self.checkpoint_interval_ms = checkpoint_interval_ms
        #: CheckpointFailureManager policy: storage-failed and timed-out
        #: checkpoints beyond this many CONSECUTIVE failures fail the
        #: execution, which the restart loop recovers from the latest
        #: completed checkpoint (-1 = unlimited tolerance)
        self.failure_manager = CheckpointFailureManager(
            tolerable_failed_checkpoints)
        self.checkpoint_timeout_s = checkpoint_timeout_s
        #: restart attempts performed by the current run() — exported with
        #: the failure manager's counters on a job-scope metric group
        self._restarts = 0
        from flink_tpu_torch.metrics.groups import (MetricRegistry,
                                                    job_checkpoint_metrics)
        self.metrics_registry = MetricRegistry()
        self.job_metric_group = job_checkpoint_metrics(
            self.metrics_registry.job_manager_group(), self.failure_manager,
            lambda: self._restarts)
        #: local recovery: workers keep secondary snapshot copies under
        #: this directory and restore from them on same-worker restarts
        #: (``state.backend.local-recovery`` analog); stats from workers
        #: land in ``recovery_stats`` as (worker, local_hits, remote_reads)
        self.local_recovery_dir = local_recovery_dir
        self.recovery_stats: List[Tuple[int, int, int]] = []
        #: run fingerprint: local-store entries are scoped to ONE cluster
        #: run — a reused local_recovery_dir must never serve a previous
        #: run's chk-N files (checkpoint ids restart at 1 per run)
        import uuid
        self.run_token = uuid.uuid4().hex[:16]
        self.extra_sys_path = tuple(extra_sys_path)
        #: optional SecurityConfig: mutual TLS on control + data plane and/or
        #: an HMAC token handshake on worker registration
        self.security = security
        #: spawn=True runs workers as local subprocesses; spawn=False only
        #: LISTENS — workers are started externally (k8s pods, other hosts)
        #: and dial in with `flink_tpu_torch worker --coordinator host:port`
        self.spawn = spawn
        _require_secure_bind(bind_host, security,
                             "ProcessCluster control plane")
        self.bind_host = bind_host
        self.listen_port = listen_port
        #: worker-loss recovery (spawn=True only): a failed execution is
        #: retried up to this many times, restoring from the LATEST
        #: completed checkpoint — the full-restart failover strategy (the
        #: all-to-all edges make the whole job one pipelined region)
        self.restart_attempts = restart_attempts
        self.restart_delay_ms = restart_delay_ms
        #: prefer IN-PLACE recovery on worker loss (respawn the dead
        #: process, redeploy tasks from the latest checkpoint, keep
        #: surviving processes up) over a full-cluster restart
        self.worker_recovery = worker_recovery
        self._recovering = False
        self._reset_cv = threading.Condition()
        self._reset_acks: set = set()
        self._lock = threading.Lock()
        self._next_cid = 1
        self._completed_ids: List[int] = []
        self._counts: Dict[str, int] = {}
        self._reset_attempt()

    def _reset_attempt(self) -> None:
        """Fresh per-execution state (checkpoint ids keep increasing)."""
        #: generation guard: event threads of a PREVIOUS attempt (late EOFs
        #: from killed workers) must not touch this attempt's state
        self._gen = getattr(self, "_gen", 0) + 1
        self._states: Dict[Tuple[str, int], str] = {}
        self._state_log: List[Tuple[str, int, str]] = []
        self._last_recovery: Optional[str] = None
        self._finals: Dict[Tuple[str, int], Dict[str, Any]] = {}
        self._rows: Dict[Tuple[str, int], List[Dict[str, Any]]] = {}
        self._pending: Optional[_Pending] = None
        self._failed: Optional[str] = None
        #: previous completed checkpoint as a RESOLVED (increment-free)
        #: tree — the base increment acks of the next cut resolve against;
        #: reset per attempt (a restored execution's first cut is full)
        self._latest_resolved: Optional[Dict[str, Any]] = None
        self._done_workers: set = set()
        #: control connections that hit EOF this attempt: collect_trace
        #: must not wait its full timeout on a worker that can never
        #: answer (a SIGKILLed worker's socket EOFs long before reaping)
        self._dead_conn_idx: set = set()
        self._all_done = threading.Event()
        self._conns: Dict[int, socket.socket] = {}
        self._send_locks: Dict[int, threading.Lock] = {}

    # -- queryable serving tier -------------------------------------------
    def enable_queryable(self, *_args, **_kwargs):
        """Checkpoint-consistency read replicas of a vertex's keyed state:
        they come with the serving tier (ROADMAP Queue A item 10)."""
        raise _later_queryable()

    def start_queryable_server(self, *_args, **_kwargs):
        """The TCP front end of the serving tier (item 10)."""
        raise _later_queryable()

    def queryable_stats(self):
        """The serving tier's staleness view (item 10)."""
        raise _later_queryable()

    def queryable_endpoints(self):
        """The workers' serving endpoints (item 10)."""
        raise _later_queryable()

    # -- cross-process trace assembly --------------------------------------
    def collect_trace(self, timeout_s: float = 15.0) -> Dict[str, Any]:
        """Pull every live worker's span ring over the control plane and
        merge them — with per-worker clock-offset estimation — into ONE
        Chrome trace-event timeline (Perfetto-loadable).  Workers that
        died or time out are simply absent from the merge."""
        from flink_tpu_torch.observability.assembly import merge_timelines
        from flink_tpu_torch.utils import clock as _clock

        with self._trace_cv:
            self._trace_dumps = []
        t0_ms = float(_clock.now_ms())
        conns = [i for i in self._conns if i not in self._dead_conn_idx]
        for idx in conns:
            self._to_worker(idx, ("trace_request",))
        deadline = time.monotonic() + timeout_s
        with self._trace_cv:
            while time.monotonic() < deadline:
                # recompute the live set every pass: a worker dying
                # MID-collect must shrink what we wait for, not stall
                # the merge until the full timeout.  Match by INDEX, not
                # count — a worker that answers and THEN dies would
                # otherwise satisfy another live worker's quota
                answered = {d[0] for d in self._trace_dumps}
                if all(i in answered or i in self._dead_conn_idx
                       for i in conns):
                    break
                self._trace_cv.wait(timeout=0.2)
            dumps = list(self._trace_dumps)
        j = self._trace_journal
        merged = merge_timelines(j.snapshot() if j is not None else None,
                                 dumps, t0_ms=t0_ms)
        merged["otherData"]["requested_workers"] = len(conns)
        self.last_trace = merged
        return merged

    # -- lifecycle ---------------------------------------------------------
    def run(self, timeout_s: float = 180.0,
            restore: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Execute, restarting from the latest completed checkpoint on
        failure (up to ``restart_attempts`` times, spawned workers only).

        Collect-sink rows come from the FINAL execution; since r3 the
        CollectSink checkpoints its collected rows, so recovery from a
        completed checkpoint preserves pre-checkpoint rows (exactly-once
        for collect too).  Production delivery still belongs to the
        transactional sinks (``connectors/sinks.py``,
        ``connectors/log_service.py``) — the collect path keeps its whole
        result in memory/checkpoints by design."""
        from flink_tpu_torch.observability import tracing as tracing_mod

        restore = self._ha_takeover(restore)
        original_restore = restore
        if self.tracing:
            # shared ownership state machine with MiniCluster.execute —
            # per-execution reset of an owned coordinator ring, fresh ring
            # when an adopted one's owner released, re-adoption otherwise
            self._trace_journal, self._owns_trace_journal = \
                tracing_mod.acquire_for_execution(
                    self._trace_journal, self._owns_trace_journal,
                    capacity=int(self.ckpt_opts.get("trace_capacity")
                                 or 65536))
        j, owned = self._trace_journal, self._owns_trace_journal
        try:
            return self._run_attempts(timeout_s, restore, original_restore)
        finally:
            self._ha_shutdown()
            # self._trace_journal/last_trace keep serving afterwards
            tracing_mod.release_after_execution(j, owned)

    # -- coordinator HA -----------------------------------------------------
    @classmethod
    def from_ha(cls, ha_store, job_id: str, checkpoint_storage=None,
                **overrides) -> "ProcessCluster":
        """Standby takeover: rebuild a coordinator for a job REGISTERED in
        the HA store (``register_job`` persisted the reference + settings
        under the registering leader's epoch).  ``run()`` then acquires
        the lease at epoch+1 and restores from the completed-checkpoint
        pointer."""
        payload = ha_store.load_job(job_id)
        kw = dict(payload.get("settings") or {})
        kw.update(overrides)
        kw.setdefault("n_workers", payload.get("n_workers", 2))
        return cls(payload["job"], checkpoint_storage=checkpoint_storage,
                   ha_store=ha_store, ha_job_id=job_id, **kw)

    def _ha_takeover(self, restore):
        """Acquire the leader lease (epoch+1 over any predecessor),
        register the job, resolve the restore from the HA
        completed-checkpoint pointer, and start renewing.  Returns the
        (possibly pointer-resolved) restore."""
        if self.ha_store is None:
            return restore
        from flink_tpu_torch.runtime import ha as ha_mod

        holder = f"coordinator-{os.getpid()}-{self.run_token}"
        self._lease = self.ha_store.acquire(
            holder, self.ha_lease_ttl_s,
            timeout_s=max(30.0, 10 * self.ha_lease_ttl_s))
        self._epoch = self._lease.epoch
        # epoch-partitioned checkpoint ids: this incarnation can never
        # collide with a zombie predecessor writing the same directory
        self._next_cid = max(self._next_cid,
                             (self._epoch - 1) * _CID_EPOCH_STRIDE + 1)
        self.ha_store.register_job(
            self.ha_job_id,
            {"job": self.job, "n_workers": self.n_workers,
             "settings": {
                 "checkpoint_interval_ms": self.checkpoint_interval_ms,
                 "checkpoint_timeout_s": self.checkpoint_timeout_s,
                 "incremental": bool(self.ckpt_opts.get("incremental"))}},
            self._epoch)
        if restore is None:
            restore, src = ha_mod.resolve_restore(
                self.ha_store, self.ha_job_id, self.checkpoint_storage)
            self.ha_restore_source = src
        if self.checkpoint_storage is not None \
                and hasattr(self.checkpoint_storage, "pin_provider"):
            # retention pinning (satellite 2): the storage re-reads the
            # HA pointer FRESH at every eviction pass, so even a stale
            # leader's concurrent retention never evicts the pointed-at
            # cut (or its increment chain)
            store, job_id = self.ha_store, self.ha_job_id

            def _ha_pin() -> Optional[int]:
                ptr = store.completed_checkpoint(job_id)
                return ptr["checkpoint_id"] if ptr else None

            self.checkpoint_storage.pin_provider = _ha_pin
        self._renewer = ha_mod.LeaseRenewer(
            self.ha_store, self._lease, self.ha_lease_ttl_s,
            on_lost=self._ha_demoted)
        self._renewer.start()
        return restore

    def _ha_shutdown(self) -> None:
        if self._renewer is not None:
            self._renewer.stop()
            self._renewer.join()
            # release only a lease we still hold and cleanly finished
            # with, so a successor skips the TTL wait; a LOST lease (or
            # an injected renewal fault) belongs to whoever took it
            if self._renewer.lost is None and self._lease is not None:
                try:
                    self.ha_store.release(self._renewer.lease)
                except Exception:  # noqa: BLE001
                    pass
            self._renewer = None

    def _ha_demoted(self, exc: Exception) -> None:
        """Lease renewal failed (TTL expired under us, a new leader took
        over, or an injected ``ha.lease`` truncation): demote LOUDLY —
        fail the run so nothing further completes under the stale epoch."""
        with self._lock:
            if self._failed is None:
                self._failed = (f"leader lease lost (epoch {self._epoch}): "
                                f"{exc}")
            self._all_done.set()

    def ha_status(self) -> Dict[str, Any]:
        """HA panel: leader epoch, lease, fence counters, restore source —
        what the REST ``/jobs/<id>/ha`` endpoint serves."""
        lease = self._renewer.lease if self._renewer is not None \
            else self._lease
        lost = self._renewer.lost if self._renewer is not None else None
        return {"enabled": self.ha_store is not None,
                "leader_epoch": self._epoch,
                "job_id": self.ha_job_id,
                "holder": lease.holder if lease is not None else None,
                "lease_deadline": lease.deadline if lease is not None
                else None,
                "demoted": lost is not None,
                "restore_source": self.ha_restore_source,
                "fenced_completions": self.ha_fenced_completions,
                "fenced_worker_msgs": self.fenced_worker_msgs}

    def _run_attempts(self, timeout_s: float,
                      restore: Optional[Dict[str, Any]],
                      original_restore: Optional[Dict[str, Any]]
                      ) -> Dict[str, Any]:
        attempt = 0
        self._restarts = 0
        while True:
            self._restarts = attempt
            if attempt > 0:
                self._reset_attempt()
                self.failure_manager.on_job_restart()
                # restore from this run's newest completed checkpoint
                # (under HA, the store's completed-checkpoint POINTER is
                # consulted first — the same truth a standby leader uses),
                # else the restore the CALLER supplied (a savepoint must
                # not silently drop)
                restore = self._latest_restore(original_restore)
            res = self._run_once(timeout_s, restore, attempt)
            res["attempts"] = attempt + 1
            if res["state"] == "FINISHED" or attempt >= self.restart_attempts \
                    or not self.spawn:
                return res
            attempt += 1
            time.sleep(self.restart_delay_ms / 1000.0)

    def _setup_source_coordinator(self, plan, restore) -> None:
        """Enumerators live HERE, on the coordinator
        (``SourceCoordinator.java:75``); readers request splits via
        split_request control messages.  Restore reconciles reader-owned
        splits (in-flight + consumed) into the assigned sets."""
        from flink_tpu_torch.connectors.enumerator import SourceCoordinator

        self._source_coordinator = SourceCoordinator()
        for v in plan.vertices:
            if v.is_source:
                src = v.chain[0].source
                factory = getattr(src, "create_enumerator", None)
                if factory is not None:
                    self._source_coordinator.register(v.uid, factory())
        if restore:
            self._source_coordinator.restore(restore.get("__enumerators__"))
            for uid, enum in self._source_coordinator._enums.items():
                for s in (restore.get(uid) or {}).get("subtasks", []):
                    if not s:
                        continue
                    if s.get("current_split") is not None:
                        enum.reclaim(s["current_split"])
                    for fs in s.get("finished_splits", []):
                        enum.reclaim(fs)

    def _run_once(self, timeout_s: float,
                  restore: Optional[Dict[str, Any]],
                  attempt: int = 0) -> Dict[str, Any]:
        plan = build_plan(self.job)
        # shipped with every deploy; workers verify their own rebuild
        # against it (nondeterministic job builders fail fast)
        self._plan_digest = plan_structure_digest(plan)
        self._counts, _ = subtask_counts_of(plan)
        if restore:
            # a restore taken at a DIFFERENT parallelism (an autoscaler
            # cut, a resized redeploy) redistributes through the key-group
            # path — persisted in-flight channel state included — before
            # it ships to the workers; matching snapshots pass untouched
            from flink_tpu_torch.cluster.adaptive import maybe_rescale_restore
            restore = maybe_rescale_restore(restore, plan)
        all_subtasks = {(uid, i) for uid, n in self._counts.items()
                        for i in range(n)}
        self._setup_source_coordinator(plan, restore)
        # NOTE: no implicit load_latest() here — a fresh run with a reused
        # --checkpoint-dir starts fresh unless the caller passed an explicit
        # restore (the reference's -s savepoint semantics); the restart loop
        # in run() consults the latest checkpoint only for attempt > 0
        srv = socket.create_server((self.bind_host, self.listen_port))
        _, cport = srv.getsockname()[:2]
        self.control_port = cport
        procs: List[subprocess.Popen] = []
        if self.spawn:
            self._spawn_env = env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                (*self.extra_sys_path, *sys.path, env.get("PYTHONPATH", "")))
            if self.security is not None:
                if self.security.internal_ssl:
                    env["FLINK_TPU_SSL_CERT"] = self.security.cert_path
                    env["FLINK_TPU_SSL_KEY"] = self.security.key_path
                    env["FLINK_TPU_SSL_CA"] = self.security.ca_path
                if self.security.auth_token:
                    env["FLINK_TPU_AUTH_TOKEN"] = self.security.auth_token
            # failure-injection hooks / logs can key on the execution attempt
            env["FLINK_TPU_ATTEMPT"] = str(attempt)
            if self.local_recovery_dir:
                env["FLINK_TPU_LOCAL_RECOVERY"] = self.local_recovery_dir
                env["FLINK_TPU_RUN_TOKEN"] = self.run_token
            procs = [self._spawn_worker(i, cport)
                     for i in range(self.n_workers)]
        self._procs = procs  # chaos tests / operators can observe pids
        try:
            # spawned workers register within seconds; external (pod) workers
            # may take as long as the cluster scheduler needs.  The limit is
            # an OVERALL deadline — stray connections (probes/scans) must
            # not keep resetting it
            reg_deadline = time.monotonic() + (90 if self.spawn
                                               else timeout_s)
            server_ctx = (self.security.server_context()
                          if self.security is not None
                          and self.security.internal_ssl else None)
            need_token = (self.security is not None
                          and bool(self.security.auth_token))
            addresses: Dict[int, Tuple[str, int]] = {}
            hello_conns: List[Tuple[int, socket.socket]] = []
            tmp_lock = threading.Lock()
            try:
                self._register_workers(srv, server_ctx, need_token,
                                       addresses, hello_conns, tmp_lock,
                                       reg_deadline)
            except socket.timeout as e:
                # a worker that died before saying hello (startup crash)
                # must yield a FAILED result the restart loop can retry,
                # not an escaped exception
                for _i, c in hello_conns:
                    try:
                        c.close()
                    except OSError:
                        pass
                self._failed = (f"worker registration timed out "
                                f"({len(hello_conns)}/{self.n_workers} "
                                f"registered: {e})")
                return {"state": "FAILED", "error": self._failed,
                        "rows": [], "recoveries": 0,
                        "completed_checkpoints": list(self._completed_ids)}
            for idx, conn in hello_conns:
                self._conns[idx] = conn
                self._send_locks[idx] = threading.Lock()
            threads = []
            for idx, conn in hello_conns:
                th = threading.Thread(target=self._serve_worker,
                                      args=(idx, conn), daemon=True)
                th.start()
                threads.append(th)
            for idx in self._conns:
                self._to_worker(idx, ("deploy", addresses, restore, None,
                                      self._plan_digest, self.ckpt_opts))
            if self.ckpt_opts.get("orphan_timeout_s"):
                self._ping_stop = threading.Event()
                threading.Thread(target=self._ping_loop,
                                 args=(self._ping_stop,),
                                 daemon=True).start()
            if self.checkpoint_interval_ms > 0:
                # the ticker loops on ITS attempt's event (self._all_done
                # is replaced between restart attempts/recoveries)
                threading.Thread(
                    target=self._checkpoint_loop,
                    args=(all_subtasks, self._all_done), daemon=True).start()
            # ---- main wait, with SURVIVING-WORKER recovery: a dead worker
            # process is respawned and only the TASKS redeploy (from the
            # latest checkpoint, everywhere — consistency); surviving
            # worker processes stay up with their data-plane addresses
            # (the local-recovery posture; with all-to-all keyed edges the
            # whole job is one pipelined region, so all tasks roll back,
            # but no surviving process restarts)
            deadline = time.monotonic() + timeout_s
            recoveries = 0
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._all_done.wait(
                        timeout=remaining):
                    self._failed = self._failed or "timeout"
                    break
                if self._failed is None:
                    break                   # finished cleanly
                dead = [i for i, p in enumerate(procs)
                        if p.poll() is not None]
                if not dead and self._failed and "died" in str(self._failed):
                    # SIGKILL delivery/reaping can lag the control-plane
                    # EOF by a moment: give the child a beat to be
                    # observable before falling back to a full restart
                    end = time.monotonic() + 5
                    while not dead and time.monotonic() < end:
                        time.sleep(0.05)
                        dead = [i for i, p in enumerate(procs)
                                if p.poll() is not None]
                if not (self.spawn and self.worker_recovery and dead
                        and recoveries < self.restart_attempts
                        and time.monotonic() < deadline):
                    break                   # full-restart path handles it
                recoveries += 1
                time.sleep(self.restart_delay_ms / 1000.0)
                self._recover_workers(plan, procs, dead, addresses, srv,
                                      server_ctx, need_token, cport,
                                      restore)
                if self.checkpoint_interval_ms > 0:
                    threading.Thread(
                        target=self._checkpoint_loop,
                        args=(all_subtasks, self._all_done),
                        daemon=True).start()
            # assemble the merged cross-worker timeline BEFORE stopping
            # the workers (their control loops must still answer).  The
            # latency panel rides the same collection, and a latency
            # interval WITHOUT tracing still deserves its histograms —
            # the workers answer trace_request with journal=None then.
            trace = None
            latency_rows = None
            if self.tracing or self.ckpt_opts.get("latency_interval_ms"):
                merged = self.collect_trace()
                rows = merged["otherData"].get("latency") or []
                # the documented contract: latency_interval_ms alone
                # always yields result["latency"] — an empty panel (no
                # marker observed before the job finished) is an empty
                # list, not a missing key
                if rows or self.ckpt_opts.get("latency_interval_ms"):
                    latency_rows = rows
                if self.tracing:
                    trace = merged
            for idx in self._conns:
                self._to_worker(idx, ("stop",))
            for p in procs:
                try:
                    p.wait(timeout=15)
                except subprocess.TimeoutExpired:
                    p.kill()
            state = "FAILED" if self._failed else "FINISHED"
            rows: List[Dict[str, Any]] = []
            for key in sorted(self._rows):
                rows.extend(self._rows[key])
            return {"state": state, "error": self._failed, "rows": rows,
                    "recoveries": recoveries,
                    "completed_checkpoints": list(self._completed_ids),
                    "failed_checkpoints": self.failure_manager.num_failed(),
                    "checkpoint_stats": list(self._checkpoint_stats),
                    **({"trace": trace} if trace is not None else {}),
                    **({"latency": latency_rows}
                       if latency_rows is not None else {})}
        finally:
            self._all_done.set()   # stop this attempt's checkpoint ticker
            if getattr(self, "_ping_stop", None) is not None:
                self._ping_stop.set()
            srv.close()
            # close control connections so stale _serve_worker threads
            # unblock, and reap every child before a potential retry
            for conn in self._conns.values():
                try:
                    conn.close()
                except OSError:
                    pass
            for p in procs:
                if p.poll() is None:
                    p.kill()
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass

    def _spawn_worker(self, index: int, cport: int) -> subprocess.Popen:
        return subprocess.Popen(
            [sys.executable, "-m", "flink_tpu_torch", "worker",
             "--index", str(index), "--workers", str(self.n_workers),
             "--job", self.job, "--coordinator", f"127.0.0.1:{cport}",
             "--device", str(self.device)],
            env=self._spawn_env)

    def _respawn_and_register(self, procs, dead, addresses, srv, server_ctx,
                              need_token: bool, cport: int) -> bool:
        """Respawn the dead worker processes and register ONLY them; wires
        their control connections + serve threads.  False = registration
        failed (the attempt was marked FAILED)."""
        for i in dead:
            procs[i] = self._spawn_worker(i, cport)
        new_addr: Dict[int, Tuple[str, int]] = {}
        new_conns: List[Tuple[int, socket.socket]] = []
        try:
            self._register_workers(srv, server_ctx, need_token, new_addr,
                                   new_conns, threading.Lock(),
                                   time.monotonic() + 90,
                                   expected=len(dead), allowed=set(dead))
        except socket.timeout:
            with self._lock:
                self._failed = "respawned worker failed to register"
                self._all_done.set()
            self._recovering = False
            return False
        addresses.update(new_addr)
        for idx, conn in new_conns:
            self._conns[idx] = conn
            self._send_locks[idx] = threading.Lock()
            with self._lock:
                # the respawned worker's NEW control conn can answer
                # trace_requests again — leaving it in the dead set would
                # silently drop its ring from the merged timeline on
                # exactly the recovered-worker runs the trace explains
                self._dead_conn_idx.discard(idx)
            threading.Thread(target=self._serve_worker, args=(idx, conn),
                             daemon=True).start()
        return True

    def _latest_restore(self, original_restore):
        """This run's newest completed checkpoint, else the original
        restore the run started from.  A load failure (corrupt increment
        chain, transient read error) falls back to progressively older
        completed checkpoints — recovery must not die on one bad file.

        Under HA the store's completed-checkpoint pointer is truth
        (satellite 2): it survives coordinator death, so a restarted or
        standby leader restores exactly the cut the last leader durably
        completed; the directory scan stays as a logged fallback inside
        :func:`flink_tpu_torch.runtime.ha.resolve_restore`."""
        if self.ha_store is not None:
            from flink_tpu_torch.runtime import ha as ha_mod
            snap, src = ha_mod.resolve_restore(
                self.ha_store, self.ha_job_id, self.checkpoint_storage)
            if snap is not None:
                self.ha_restore_source = src
                return snap
        if self.checkpoint_storage is not None and self._completed_ids:
            for cid in sorted(self._completed_ids, reverse=True):
                try:
                    return self.checkpoint_storage.load(cid)
                except Exception:  # noqa: BLE001
                    continue
        return original_restore

    def _affected_region_subtasks(self, plan, dead) -> Optional[set]:
        """(vertex_uid, i) set of the pipelined regions touched by the dead
        workers, or None when region-scoped recovery does not apply (the
        whole job is affected, or a runtime-enumerated source shares
        enumerator state across regions)."""
        from flink_tpu_torch.cluster.failover import subtask_regions

        counts, splits_by_vertex = subtask_counts_of(plan)
        if any(s is None for s in splits_by_vertex.values()):
            return None     # dynamic enumerator: shared coordinator state
        assign = assign_subtasks(plan, counts, self.n_workers)
        dead_subs = {st for st, w in assign.items() if w in set(dead)}
        affected: set = set()
        for region in subtask_regions(plan, counts):
            if region & dead_subs:
                affected |= region
        if not affected or affected == set(assign):
            return None     # everything (or nothing) affected: full path
        return affected

    def _recover_workers(self, plan, procs, dead, addresses, srv,
                         server_ctx, need_token: bool, cport: int,
                         original_restore) -> None:
        """In-place recovery: quiesce (only the affected regions of)
        survivors, respawn the dead worker processes, redeploy the affected
        tasks from this run's latest checkpoint.  Surviving processes (and
        their data-plane servers) never restart, and with region-scoped
        recovery the surviving regions' TASKS keep running too — the
        reference's ``RestartPipelinedRegionFailoverStrategy`` + local
        recovery."""
        affected = self._affected_region_subtasks(plan, dead)
        if affected is not None:
            return self._recover_regions(plan, procs, dead, affected,
                                         addresses, srv, server_ctx,
                                         need_token, cport, original_restore)
        self._last_recovery = "full"
        self._recovering = True
        old_done = self._all_done
        survivors = [i for i in range(self.n_workers) if i not in dead]
        # 1. quiesce survivors (tasks cancel, channels drop, process stays)
        with self._reset_cv:
            self._reset_acks = set()
        for i in survivors:
            self._to_worker(i, ("reset",))
        end = time.monotonic() + 30
        with self._reset_cv:
            while not set(survivors) <= self._reset_acks \
                    and time.monotonic() < end:
                self._reset_cv.wait(timeout=1.0)
        # 2. respawn dead workers and register ONLY them
        if not self._respawn_and_register(procs, dead, addresses, srv,
                                          server_ctx, need_token, cport):
            return
        # 3. fresh attempt state (conns, gen and serve threads survive)
        with self._lock:
            self._states = {}
            self._finals = {}
            self._rows = {}
            self._pending = None
            self._failed = None
            # the redeploy restores operators, so their first cut is a
            # full base — the old resolution base is no longer the parent
            self._latest_resolved = None
            self._done_workers = set()
            self._all_done = threading.Event()
            # failover: in-flight checkpoint attempts die with the old
            # execution, so the continuous-failure window restarts too
            self.failure_manager.on_job_restart()
        old_done.set()  # stop the previous checkpoint ticker
        # 4. redeploy from this run's latest completed checkpoint
        restore = self._latest_restore(original_restore)
        self._setup_source_coordinator(plan, restore)
        self._recovering = False
        for idx in self._conns:
            self._to_worker(idx, ("deploy", addresses, restore, None,
                                  self._plan_digest, self.ckpt_opts))

    def _recover_regions(self, plan, procs, dead, affected: set, addresses,
                         srv, server_ctx, need_token: bool, cport: int,
                         original_restore) -> None:
        """Region-scoped recovery: only the pipelined
        regions touched by the dead workers roll back; every other region's
        tasks keep RUNNING throughout — matching
        ``RestartPipelinedRegionFailoverStrategy.java``."""
        self._last_recovery = "region"
        self._recovering = True
        old_done = self._all_done
        counts, _ = subtask_counts_of(plan)
        assign = assign_subtasks(plan, counts, self.n_workers)
        touched_workers = {assign[st] for st in affected}
        survivors_touched = sorted(touched_workers - set(dead))
        # 1. cancel ONLY affected tasks on touched survivors
        with self._reset_cv:
            self._reset_acks = set()
        for i in survivors_touched:
            self._to_worker(i, ("reset_tasks", sorted(affected)))
        end = time.monotonic() + 30
        with self._reset_cv:
            while not set(survivors_touched) <= self._reset_acks \
                    and time.monotonic() < end:
                self._reset_cv.wait(timeout=1.0)
        # 2. respawn dead workers and register ONLY them
        if not self._respawn_and_register(procs, dead, addresses, srv,
                                          server_ctx, need_token, cport):
            return
        # 3. reset ONLY the affected tasks' bookkeeping; unaffected
        # regions' states, finals and collected rows stay
        with self._lock:
            for key in affected:
                self._states.pop(key, None)
                self._finals.pop(key, None)
                self._rows.pop(key, None)
            self._pending = None            # in-flight checkpoint aborts
            self._failed = None
            # _latest_resolved survives region recovery ON PURPOSE: the
            # unaffected regions' operators keep their increment chains
            # (anchored at the last completed cut == _latest_resolved),
            # while the affected regions restore and ack full cuts that
            # replace their subtrees wholesale during resolution
            # region failover restarts the continuous-failure window, same
            # as a full restart (MiniCluster does this per region restart)
            self.failure_manager.on_job_restart()
            self._done_workers -= touched_workers
            self._all_done = threading.Event()
        old_done.set()  # stop the previous checkpoint ticker
        # 4. redeploy the affected regions from the latest checkpoint
        restore = self._latest_restore(original_restore)
        self._recovering = False
        only = sorted(affected)
        for idx in sorted(touched_workers):
            self._to_worker(idx, ("deploy", addresses, restore, only,
                                  self._plan_digest, self.ckpt_opts))

    def _register_workers(self, srv, server_ctx, need_token: bool,
                          addresses: Dict[int, Tuple[str, int]],
                          hello_conns: List[Tuple[int, socket.socket]],
                          tmp_lock: threading.Lock,
                          deadline: float,
                          expected: Optional[int] = None,
                          allowed: Optional[set] = None) -> None:
        """Accept until ``expected`` (default: all) workers said a valid
        hello; raises ``socket.timeout`` once the OVERALL deadline passes.
        ``allowed`` restricts acceptable worker indices (recovery accepts
        only the respawned ones)."""
        target = self.n_workers if expected is None else expected
        while len(hello_conns) < target:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("worker registration deadline")
            # a spawned worker that exits before its hello (a start-up
            # crash: a device it cannot open) fails the attempt now, not
            # at the deadline
            for i, p in enumerate(getattr(self, "_procs", None) or ()):
                if i not in addresses and (allowed is None or i in allowed) \
                        and p.poll() is not None:
                    raise socket.timeout(f"worker {i} exited with code "
                                         f"{p.returncode} before registering")
            srv.settimeout(min(remaining, 0.5))
            try:
                conn, _addr = srv.accept()
            except socket.timeout:
                continue
            # a stray connection (readiness probe, port scan, wrong token)
            # must neither consume a registration slot nor fail the job —
            # drop it and keep accepting
            try:
                # timeout BEFORE the TLS handshake: a silent connection
                # must not park the accept loop inside wrap_socket
                conn.settimeout(30)
                if server_ctx is not None:
                    conn = server_ctx.wrap_socket(conn, server_side=True)
                nonce = os.urandom(32) if need_token else None
                _send_json(conn, {"kind": "challenge",
                                  "nonce": nonce.hex() if nonce else None},
                           tmp_lock)
                # the hello is JSON (parsed, never unpickled) and the HMAC
                # is verified BEFORE this connection graduates to the
                # pickle control protocol
                msg = _recv_json(conn)
                if not isinstance(msg, dict) or msg.get("kind") != "hello":
                    conn.close()
                    continue
                idx, host = msg.get("index"), msg.get("host")
                port, mac_hex = msg.get("port"), msg.get("mac")
                if not isinstance(idx, int) \
                        or not 0 <= idx < self.n_workers \
                        or idx in addresses \
                        or (allowed is not None and idx not in allowed) \
                        or not isinstance(host, str) \
                        or not isinstance(port, int):
                    conn.close()
                    continue
                if need_token:
                    try:
                        mac = bytes.fromhex(mac_hex or "")
                    except (TypeError, ValueError):
                        mac = b""  # non-string / malformed hex: fails verify
                    if not self.security.verify(nonce, mac):
                        conn.close()
                        continue
                conn.settimeout(None)
            except socket.timeout:
                # per-connection stall, NOT the accept timeout: drop it
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            except (OSError, ValueError, pickle.UnpicklingError):
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            addresses[idx] = (host, port)
            hello_conns.append((idx, conn))

    def _to_worker(self, idx: int, msg) -> None:
        # every control message carries the leader epoch as its last
        # element; epoch 0 = HA off, workers admit everything
        msg = tuple(msg) + (self._epoch,)
        try:
            _send_msg(self._conns[idx], msg, self._send_locks[idx])
        except OSError:
            pass

    def _ping_loop(self, stop: threading.Event) -> None:
        """Leader liveness pings: workers reset their orphan-reaper
        deadline on every control message, so a quiet-but-alive leader
        (long checkpoint interval, idle job) keeps its workers."""
        while not stop.wait(self.ping_interval_s):
            for idx in list(self._conns):
                if idx not in self._dead_conn_idx:
                    self._to_worker(idx, ("ping",))

    # -- per-worker event loop --------------------------------------------
    def _serve_worker(self, idx: int, conn: socket.socket) -> None:
        gen = self._gen
        while True:
            try:
                msg = _recv_msg(conn)
            except OSError:
                msg = None
            if gen != self._gen:
                return  # a restart superseded this attempt: stale thread
            if msg is None:
                with self._lock:
                    if gen == self._gen:
                        # done or not, this conn can never answer a
                        # trace_request again — unblock any collector
                        self._dead_conn_idx.add(idx)
                    if gen == self._gen and idx not in self._done_workers \
                            and self._failed is None:
                        self._failed = f"worker {idx} died"
                        self._all_done.set()
                with self._trace_cv:
                    self._trace_cv.notify_all()
                return
            kind = msg[0]
            if kind == "state":
                _, uid, i, state, error = msg
                with self._lock:
                    self._states[(uid, i)] = state
                    # full transition history (tests/observability: proves
                    # which subtasks restarted during a recovery)
                    self._state_log.append((uid, i, state))
                    if state == "FAILED" and self._failed is None:
                        self._failed = f"{uid}[{i}]: {error}"
                        self._all_done.set()
                    p = self._pending
                    if state == "FINISHED" and p is not None \
                            and (uid, i) not in p.acks:
                        p.expected.discard((uid, i))
                        if len(p.acks) >= len(p.expected):
                            self._complete(p)
            elif kind == "plan_mismatch":
                _, widx, local, expected = msg
                with self._lock:
                    if self._failed is None:
                        self._failed = (
                            f"worker {widx} rebuilt a DIFFERENT plan "
                            f"(structure digest {local} != coordinator's "
                            f"{expected}): the job builder is "
                            f"nondeterministic — deploy rejected")
                        self._all_done.set()
            elif kind == "recovery_stats":
                with self._lock:
                    self.recovery_stats.append((msg[1], msg[2], msg[3]))
            elif kind == "final":
                _, uid, i, snap = msg
                with self._lock:
                    self._finals[(uid, i)] = snap
                    # a completion deferred on this final (state FINISHED
                    # arrived first) proceeds now that the state is whole
                    p = self._pending
                    if p is not None and len(p.acks) >= len(p.expected):
                        self._complete(p)
            elif kind == "ack":
                cid, uid, i, snap = msg[1:5]
                ack_epoch = msg[5] if len(msg) > 5 else 0
                with self._lock:
                    if ack_epoch and self._epoch \
                            and ack_epoch < self._epoch:
                        # a stale incarnation's worker acking into the new
                        # leader: its snapshot belongs to a fenced epoch
                        self.fenced_worker_msgs += 1
                        continue
                    p = self._pending
                    if p is not None and p.cid == cid:
                        p.acks[(uid, i)] = snap
                        if len(p.acks) >= len(p.expected):
                            self._complete(p)
            elif kind == "decline":
                _, cid, uid, i, error = msg
                from flink_tpu_torch.runtime.checkpoint.failure import \
                    CheckpointFailureReason
                with self._lock:
                    p = self._pending
                    if p is not None and p.cid == cid:
                        # abort the attempt, charge the tolerable budget;
                        # the TASK stays up (decline != task failure)
                        self._pending = None
                        self._checkpoint_failure_locked(
                            CheckpointFailureReason.DECLINED, cid,
                            f"{uid}[{i}] declined: {error}")
            elif kind == "split_request":
                _, uid, i = msg
                split, done_flag = self._source_coordinator.request_split(
                    uid, i)
                self._to_worker(idx, ("split_assign", uid, i, split,
                                      done_flag))
            elif kind == "rows":
                _, uid, i, rows = msg
                with self._lock:
                    self._rows[(uid, i)] = rows
            elif kind == "trace_dump":
                from flink_tpu_torch.utils import clock as _clock
                with self._trace_cv:
                    self._trace_dumps.append((msg[1], msg[2],
                                              float(_clock.now_ms())))
                    self._trace_cv.notify_all()
            elif kind == "fenced":
                # a worker rejected one of our messages as stale-epoch:
                # we are a zombie ex-leader — count it (the decisive
                # demotion comes from the HA-store fence / lease loss)
                with self._lock:
                    self.fenced_worker_msgs += 1
            elif kind == "reset_done":
                with self._reset_cv:
                    self._reset_acks.add(msg[1])
                    self._reset_cv.notify_all()
            elif kind == "worker_done":
                with self._lock:
                    self._done_workers.add(msg[1])
                    if len(self._done_workers) >= self.n_workers:
                        self._all_done.set()

    # -- checkpointing -----------------------------------------------------
    def trigger_checkpoint(self, all_subtasks: set) -> Optional[int]:
        from flink_tpu_torch.runtime.checkpoint.failure import \
            CheckpointFailureReason

        with self._lock:
            if self._pending is not None and (
                    self._pending.timer.seconds()
                    >= self.checkpoint_timeout_s):
                # expired: abort + charge the budget (a dead worker's acks
                # will never arrive; failure detection handles the worker)
                expired = self._pending
                self._pending = None
                self._checkpoint_failure_locked(
                    CheckpointFailureReason.TIMEOUT, expired.cid,
                    f"{len(expired.acks)}/{len(expired.expected)} acks "
                    f"after {self.checkpoint_timeout_s}s")
            if self._pending is not None or self._failed is not None \
                    or self._recovering:
                return None
            live = {k for k in all_subtasks
                    if self._states.get(k) != "FINISHED"}
            if not live:
                return None
            cid = self._next_cid
            self._next_cid += 1
            coord = getattr(self, "_source_coordinator", None)
            enums = (coord.snapshot() if coord is not None and coord._enums
                     else None)
            from flink_tpu_torch.observability import tracing as tracing_mod
            tracing_mod.instant("checkpoint.trigger", cat="checkpoint",
                                checkpoint=cid)
            self._pending = _Pending(cid, live, enumerators=enums)
        for idx in self._conns:
            self._to_worker(idx, ("checkpoint", cid))
        return cid

    def _complete(self, p: _Pending) -> None:
        """Assemble + store (caller holds the lock) — mirrors
        ``MiniCluster._complete_checkpoint`` incl. FLIP-147 finals."""
        # a FINISHED subtask's state arrives as two messages (state, then
        # final); completing between them would persist a HOLE for that
        # subtask — and if its worker dies mid-send, the hole would be
        # silently restored later, losing the subtask's entire output.
        # Defer instead: the final's arrival re-runs completion; a lost
        # final leaves the pending to the checkpoint timeout / recovery
        # abort, and restore falls back to the previous intact checkpoint.
        for key, st in self._states.items():
            if st == "FINISHED" and key not in p.acks \
                    and key not in self._finals:
                return
        assembled: Dict[str, Any] = {"__job__": {
            "checkpoint_id": p.cid,
            "run_token": self.run_token,
            "parallelism": dict(self._counts)}}
        if p.enumerators:
            assembled["__enumerators__"] = p.enumerators
        for (uid, i), snap in p.acks.items():
            entry = assembled.setdefault(
                uid, {"subtasks": [None] * self._counts[uid]})
            entry["subtasks"][i] = snap
        for (uid, i), snap in self._finals.items():
            if (uid, i) not in p.acks:
                entry = assembled.setdefault(
                    uid, {"subtasks": [None] * self._counts[uid]})
                entry["subtasks"][i] = snap
        # claim completion BEFORE dropping the lock for storage I/O: late
        # acks for this id are ignored and a new trigger may start
        self._pending = None
        from flink_tpu_torch.runtime.checkpoint.failure import \
            CheckpointFailureReason
        # coordinator HA: verify leadership BEFORE any bytes
        # land — a zombie ex-leader must not even write into the shared
        # checkpoint directory.  (The decisive fence is the pointer write
        # below; this pre-check just narrows the window.)
        if self.ha_store is not None and not self._ha_fence_locked(p.cid):
            return
        # incremental checkpoints: delta-tracking operators
        # acked increment nodes — resolve them against the previous
        # completed cut so restore/queryable/rescale keep consuming the
        # dense interchange format; increment-capable storage persists the
        # RAW tree (bytes ∝ change rate), everything else the resolved cut
        from flink_tpu_torch.runtime.checkpoint import delta
        has_delta = delta.tree_has_increment(assembled)
        if has_delta:
            try:
                resolved = delta.apply_increments(self._latest_resolved,
                                                  assembled)
            except delta.IncrementChainError as e:
                self._checkpoint_failure_locked(
                    CheckpointFailureReason.STORAGE, p.cid,
                    f"IncrementChainError: {e}")
                return
        else:
            resolved = assembled
        if self.checkpoint_storage is not None:
            store_tree = assembled if (has_delta and getattr(
                self.checkpoint_storage, "supports_increments", False)) \
                else resolved
            # the store (and any retry/backoff wrapper) must not stall the
            # coordinator lock: worker events keep flowing while bytes land
            self._lock.release()
            try:
                try:
                    self.checkpoint_storage.store(p.cid, store_tree)
                except Exception as e:  # noqa: BLE001
                    store_error = f"{type(e).__name__}: {e}"
                else:
                    store_error = None
            finally:
                self._lock.acquire()
            if store_error is not None:
                # abandoned checkpoint, job keeps running — until the
                # tolerable budget is exhausted (then the restart loop
                # recovers from the latest stored checkpoint)
                self._checkpoint_failure_locked(
                    CheckpointFailureReason.STORAGE, p.cid, store_error)
                return
        # THE zombie fence: advancing the HA completed-checkpoint pointer
        # re-verifies the store epoch atomically — a checkpoint only
        # COMPLETES (and workers only get notify, so 2PC only commits) if
        # this coordinator still holds the current epoch
        if self.ha_store is not None and not self._ha_fence_locked(
                p.cid, advance=True):
            return
        self.failure_manager.on_checkpoint_success(p.cid)
        self._completed_ids.append(p.cid)
        self._latest_resolved = resolved
        # aggregate the subtasks' channel-state (v1) alignment accounting
        # (one shared reader of the schema: task.aggregate_channel_state)
        from flink_tpu_torch.cluster.task import aggregate_channel_state
        from flink_tpu_torch.observability import tracing as tracing_mod
        agg = aggregate_channel_state(p.acks.values())
        tracing_mod.complete("checkpoint", p.t0_ns, time.perf_counter_ns(),
                             cat="checkpoint", checkpoint=p.cid,
                             acked=len(p.acks),
                             unaligned=bool(agg["unaligned"]))
        from flink_tpu_torch.cluster.minicluster import _state_size
        size = _state_size(resolved)
        self._checkpoint_stats.append({
            "id": p.cid, "duration_ms": round(p.timer.ms(), 1),
            "acked_subtasks": len(p.acks),
            "state_size_bytes": size,
            # full-vs-delta accounting (== state_size_bytes on a full cut)
            "incremental": has_delta,
            "delta_bytes": _state_size(assembled) if has_delta else size,
            **agg})
        del self._checkpoint_stats[:-100]
        for idx in self._conns:
            self._to_worker(idx, ("notify", p.cid))

    def _ha_fence_locked(self, cid: int, advance: bool = False) -> bool:
        """Caller holds ``_lock``: verify this coordinator still owns the
        current leader epoch — with ``advance=True`` by durably moving the
        completed-checkpoint pointer, otherwise by a read-only epoch
        check.  A stale epoch charges the failure budget AND demotes the
        run (the zombie fails loudly, never completing the checkpoint);
        a pointer-write I/O error is charged as a storage failure."""
        from flink_tpu_torch.runtime.checkpoint.failure import \
            CheckpointFailureReason
        from flink_tpu_torch.runtime.ha import StaleEpochError
        try:
            if advance:
                self.ha_store.set_completed_checkpoint(
                    self.ha_job_id, cid, self._epoch)
            else:
                self.ha_store.check_epoch(self._epoch)
        except StaleEpochError as e:
            self.ha_fenced_completions += 1
            self.failure_manager.on_checkpoint_failure(
                CheckpointFailureReason.STORAGE, cid)
            if self._failed is None:
                self._failed = (f"checkpoint {cid} fenced: stale leader "
                                f"epoch {self._epoch}: {e}")
            self._all_done.set()
            return False
        except Exception as e:  # noqa: BLE001 — HA store I/O error
            self._checkpoint_failure_locked(
                CheckpointFailureReason.STORAGE, cid,
                f"HA pointer write failed: {type(e).__name__}: {e}")
            return False
        return True

    def _checkpoint_failure_locked(self, reason: str, cid: int,
                                   detail: str) -> None:
        """Caller holds ``_lock``: charge one checkpoint failure; past the
        tolerable budget the attempt FAILS (run() restores the next attempt
        from the latest completed checkpoint)."""
        if self.failure_manager.on_checkpoint_failure(reason, cid) \
                and self._failed is None:
            self._failed = (
                f"tolerable failed checkpoints "
                f"({self.failure_manager.tolerable}) exceeded — "
                f"checkpoint {cid} {reason}: {detail}")
            self._all_done.set()

    def _checkpoint_loop(self, all_subtasks: set, done: threading.Event) -> None:
        while not done.is_set():
            time.sleep(self.checkpoint_interval_ms / 1000.0)
            if done.is_set():
                return
            self.trigger_checkpoint(all_subtasks)

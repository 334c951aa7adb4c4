"""The serving-tier facade: registry + replicas + metrics in one object
(port of ``flink_tpu/queryable/service.py``).

``QueryableStateService`` is what a cluster wires up per job: it owns the
:class:`~flink_tpu_torch.queryable.server.KvStateRegistry`, feeds registered
:class:`~flink_tpu_torch.queryable.replica.CheckpointReplica` instances from the
cluster's checkpoint stream (on a dedicated ingest thread — the acking
task thread only enqueues), instruments every lookup with per-state
latency/qps accounting, and exposes ``stats()`` for
``job_status()["queryable"]``, the ``queryable.*`` gauges, and the REST
panel.  It answers the same ``lookup``/``lookup_batch`` interface as the
registry, so the TCP server and REST handlers serve through it and every
read is measured.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.observability import tracing
from flink_tpu_torch.queryable.cache import HotKeyCache
from flink_tpu_torch.queryable.replica import (CheckpointReplica, QueryableStateSpec,
                                               ReplicaGroup)
from flink_tpu_torch.queryable.server import KvStateRegistry, QueryableStateServer


class _LookupStats:
    """Per-state latency ring + counters (monitoring-grade: a bounded
    numpy ring, percentile math only when read)."""

    __slots__ = ("lookups", "batches", "_lat", "_n", "_i", "_t0", "_lock")

    RING = 4096

    def __init__(self):
        self.lookups = 0
        self.batches = 0
        self._lat = np.zeros(self.RING, np.float64)
        self._n = 0
        self._i = 0
        self._t0 = time.monotonic()
        self._lock = threading.Lock()

    def record(self, n_keys: int, elapsed_ms: float) -> None:
        with self._lock:
            self.lookups += n_keys
            self.batches += 1
            self._lat[self._i] = elapsed_ms
            self._i = (self._i + 1) % self.RING
            self._n = min(self._n + 1, self.RING)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            lat = self._lat[: self._n].copy()
            lookups, batches = self.lookups, self.batches
            elapsed = max(time.monotonic() - self._t0, 1e-9)
        out = {"lookups": lookups, "batches": batches,
               "lookups_per_sec": round(lookups / elapsed, 1)}
        if lat.size:
            out["lookup_p50_ms"] = round(float(np.percentile(lat, 50)), 3)
            out["lookup_p99_ms"] = round(float(np.percentile(lat, 99)), 3)
        else:
            out["lookup_p50_ms"] = out["lookup_p99_ms"] = None
        return out


class QueryableStateService:
    """One job's queryable serving tier."""

    def __init__(self, registry: Optional[KvStateRegistry] = None,
                 cache: Optional[HotKeyCache] = None,
                 cache_enabled: bool = True):
        self.registry = registry or KvStateRegistry()
        self._stats: Dict[str, _LookupStats] = {}
        self._stats_lock = threading.Lock()
        #: hot-key response cache, keyed (state, key, consistency) and
        #: invalidated by content epoch (completed-checkpoint id /
        #: fired-window counter)
        self.cache: Optional[HotKeyCache] = \
            (cache or HotKeyCache()) if cache_enabled else None
        #: server-side SERVICE time (lookup + serialization), recorded by
        #: the TCP handler — the number the client-side p99 can't see
        #: honestly on a GIL-loaded box; plus per-protocol volume
        self._serve = _LookupStats()
        self._protocols = {"binary": 0, "json": 0}
        #: checkpoint feed: the coordinator enqueues (cid, assembled) and
        #: returns immediately; this thread runs the replica ingests so
        #: snapshot parsing never runs on an acking task thread
        self._feed: "queue.Queue[Optional[Tuple[int, Dict]]]" = queue.Queue()
        self._feed_thread: Optional[threading.Thread] = None
        self._server: Optional[QueryableStateServer] = None
        self._closed = False

    # -- registration --------------------------------------------------------
    def register_views(self, name: str, views: List, parallelism: int,
                       max_parallelism: int) -> None:
        self.registry.register_views(name, views, parallelism,
                                     max_parallelism)
        # a rebuilt operator's fresh views restart their publish counter
        # at 0 — rows cached under the OLD views' epochs would otherwise
        # read as valid again the moment the new counter catches up
        if self.cache is not None:
            self.cache.clear()

    def add_replica(self, name: str, spec: QueryableStateSpec,
                    storage=None, replicas: int = 1, **kw):
        """Create + register the checkpoint replica tier for ``name``.
        With a ``storage`` it can tail independently; without, it is fed
        by :meth:`on_checkpoint_complete`.  ``replicas=N`` registers an
        N-member :class:`~flink_tpu_torch.queryable.replica.ReplicaGroup`
        instead of a single replica — reads load-balance across the
        freshest members and fail over past a partitioned one."""
        if self.cache is not None:
            self.cache.clear()   # fresh replica: old epochs may recur
        if replicas > 1:
            group = ReplicaGroup([
                CheckpointReplica(spec, storage=storage,
                                  name=f"{name}#r{i}", **kw)
                for i in range(replicas)])
            self.registry.register_replica(name, group)
            return group
        replica = CheckpointReplica(spec, storage=storage, **kw)
        self.registry.register_replica(name, replica)
        return replica

    # -- checkpoint feed -----------------------------------------------------
    def on_checkpoint_complete(self, checkpoint_id: int,
                               assembled: Dict[str, Any]) -> None:
        """Non-blocking: advertise to every replica (lag gauges move now)
        and enqueue the payload for the ingest thread."""
        for r in self.registry.replicas().values():
            r.observe_completed(checkpoint_id)
        if self._closed:
            return
        self._feed.put((checkpoint_id, assembled))
        if self._feed_thread is None:
            self._feed_thread = threading.Thread(
                target=self._feed_loop, name="queryable-replica-feed",
                daemon=True)
            self._feed_thread.start()

    def _feed_loop(self) -> None:
        while True:
            item = self._feed.get()
            try:
                if item is None:
                    return
                cid, assembled = item
                for r in self.registry.replicas().values():
                    try:
                        r.ingest_assembled(cid, assembled)
                    except Exception:  # noqa: BLE001 — a malformed state
                        pass           # must not kill the feed for others
            finally:
                self._feed.task_done()

    def drain_feed(self, timeout_s: float = 10.0) -> bool:
        """Block until enqueued checkpoints are ingested (tests/bench)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._feed.unfinished_tasks == 0:
                return True
            time.sleep(0.005)
        return False

    # -- instrumented lookups -----------------------------------------------
    def _stat(self, name: str) -> _LookupStats:
        with self._stats_lock:
            st = self._stats.get(name)
            if st is None:
                st = self._stats[name] = _LookupStats()
            return st

    def lookup(self, state_name: str, key) -> Tuple[str, Any]:
        t0 = time.perf_counter()
        out = self.registry.lookup(state_name, key)
        self._stat(state_name).record(1, (time.perf_counter() - t0) * 1e3)
        return out

    def lookup_batch(self, state_name: str, keys,
                     consistency: str = "live") -> Tuple[str, Any]:
        t0 = time.perf_counter_ns()
        out = self._lookup_batch_cached(state_name, keys, consistency)
        t1 = time.perf_counter_ns()
        self._stat(state_name).record(len(keys), (t1 - t0) / 1e6)
        tracing.complete("queryable.serve", t0, t1, cat="queryable",
                         state=state_name, keys=len(keys),
                         consistency=consistency, protocol="json")
        return out

    def _lookup_batch_cached(self, state_name: str, keys,
                             consistency: str) -> Tuple[str, Any]:
        """The dict-path lookup through the hot-key cache: per-key hits
        (valid under the state's current content epoch) answer from the
        cache; only the misses touch the registry, and their rows are
        memoized for the next reader of the same hot key."""
        cache = self.cache
        epoch = self.registry.epoch_of(state_name, consistency) \
            if cache is not None else None
        if epoch is None:
            return self.registry.lookup_batch(state_name, keys, consistency)
        keys = list(keys)
        hits, missing = cache.get_many(state_name, consistency, epoch, keys)
        if not missing:
            found = [hits[i][0] for i in range(len(keys))]
            values = [hits[i][1] for i in range(len(keys))]
            return "ok", {"found": found, "values": values,
                          "tags": self._tags_of(state_name, consistency)}
        if not hits:
            status, got = self.registry.lookup_batch(state_name, keys,
                                                     consistency)
            if status == "ok":
                cache.put_many(state_name, consistency, epoch, keys,
                               list(zip(got["found"], got["values"])))
            return status, got
        miss_keys = [keys[i] for i in missing]
        status, got = self.registry.lookup_batch(state_name, miss_keys,
                                                 consistency)
        if status != "ok":
            return status, got
        cache.put_many(state_name, consistency, epoch, miss_keys,
                       list(zip(got["found"], got["values"])))
        found: List[bool] = [False] * len(keys)
        values: List[Any] = [None] * len(keys)
        for i, (f, v) in hits.items():
            found[i], values[i] = f, v
        for j, i in enumerate(missing):
            found[i] = bool(got["found"][j])
            values[i] = got["values"][j]
        return "ok", {"found": found, "values": values,
                      "tags": got.get("tags",
                                      self._tags_of(state_name,
                                                    consistency))}

    def _tags_of(self, state_name: str, consistency: str) -> Dict[str, Any]:
        """Current tags for a fully-cache-served answer (tags are cheap —
        only the VALUES needed the locate/gather the cache skipped)."""
        status, got = self.registry.lookup_batch(state_name, [], consistency)
        if status == "ok":
            if isinstance(got, dict):
                return got.get("tags", {"consistency": consistency})
            return got[2]
        return {"consistency": consistency}

    # -- binary columnar path ------------------------------------------------
    def lookup_batch_columnar(self, state_name: str, keys,
                              consistency: str = "live") -> Tuple[str, Any]:
        """The binary wire's instrumented serve path (zero per-key Python
        objects; the hot-key cache applies to the dict path — the columnar
        gather is already cheaper than per-key cache assembly)."""
        t0 = time.perf_counter_ns()
        out = self.registry.lookup_batch_columnar(state_name, keys,
                                                  consistency)
        t1 = time.perf_counter_ns()
        self._stat(state_name).record(len(keys), (t1 - t0) / 1e6)
        tracing.complete("queryable.serve", t0, t1, cat="queryable",
                         state=state_name, keys=len(keys),
                         consistency=consistency, protocol="binary")
        return out

    # -- server-side service time (recorded by the TCP handler) -------------
    def record_serve(self, elapsed_ms: float, protocol: str) -> None:
        self._serve.record(1, elapsed_ms)
        if protocol in self._protocols:
            self._protocols[protocol] += 1

    def routing_table(self) -> Dict[str, Any]:
        return self.registry.routing_table()

    def set_default_endpoint(self, endpoint) -> None:
        self.registry.set_default_endpoint(endpoint)

    def set_state_endpoints(self, name: str, endpoints,
                            parallelism: Optional[int] = None,
                            max_parallelism: Optional[int] = None) -> None:
        self.registry.set_state_endpoints(name, endpoints,
                                          parallelism=parallelism,
                                          max_parallelism=max_parallelism)

    # -- server lifecycle ----------------------------------------------------
    def start_server(self, host: str = "127.0.0.1",
                     port: int = 0) -> QueryableStateServer:
        if self._server is None:
            self._server = QueryableStateServer(self, host=host,
                                                port=port).start()
        return self._server

    @property
    def server(self) -> Optional[QueryableStateServer]:
        return self._server

    def close(self) -> None:
        self._closed = True
        if self._feed_thread is not None:
            self._feed.put(None)
            self._feed_thread.join(timeout=5)
            self._feed_thread = None
        for r in self.registry.replicas().values():
            r.stop()
        if self._server is not None:
            self._server.stop()
            self._server = None

    # -- observability -------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """``job_status()["queryable"]`` / gauge / REST-panel shape: the
        per-state lookup accounting + every replica's staleness view, plus
        job-level aggregates (max lag across replicas — the gauges)."""
        with self._stats_lock:
            per_state = {n: s.snapshot() for n, s in self._stats.items()}
        replicas = {n: r.stats()
                    for n, r in self.registry.replicas().items()}
        for name, r in replicas.items():
            per_state.setdefault(name, {})["replica"] = r
        lookups = sum(s.get("lookups", 0) for s in per_state.values())
        qps = sum(s.get("lookups_per_sec", 0) or 0
                  for s in per_state.values())
        p50 = [s["lookup_p50_ms"] for s in per_state.values()
               if s.get("lookup_p50_ms") is not None]
        p99 = [s["lookup_p99_ms"] for s in per_state.values()
               if s.get("lookup_p99_ms") is not None]
        serve = self._serve.snapshot()
        return {
            "states": sorted(self.registry.names()),
            "per_state": per_state,
            "lookups_total": lookups,
            "lookups_per_sec": round(qps, 1),
            "lookup_p50_ms": max(p50) if p50 else None,
            "lookup_p99_ms": max(p99) if p99 else None,
            # server-side service time (lookup + serialization, measured
            # in the TCP handler) — the honest latency on a loaded box,
            # shown NEXT TO the client-side numbers, never instead
            "serve_p50_ms": serve["lookup_p50_ms"],
            "serve_p99_ms": serve["lookup_p99_ms"],
            "served_requests": serve["batches"],
            "protocols": dict(self._protocols),
            "cache": self.cache.stats() if self.cache is not None else None,
            "cache_hit_rate": (self.cache.stats()["hit_rate"]
                               if self.cache is not None else 0.0),
            "replica_lag_checkpoints": max(
                (r["replica_lag_checkpoints"] for r in replicas.values()),
                default=0),
            "replica_lag_ms": max(
                (r["replica_lag_ms"] for r in replicas.values()),
                default=0.0),
        }

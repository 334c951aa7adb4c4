"""Read replicas fed by the checkpoint stream (port of
``flink_tpu/queryable/replica.py``; it adopts snapshots of either package).

A :class:`CheckpointReplica` serves point/batch lookups at the
**last-completed-checkpoint** consistency level without ever touching the
job's hot path: it tails completed checkpoints (the per-shard slices +
key-group-range manifests of ``state/shard_layout.py`` when the writer was
mesh-sharded, dense gid-indexed snapshots otherwise), pre-combines each
key's retained panes into the final aggregate result AT INGEST, and answers
queries from those frozen arrays.  The reference designs are Flink's
queryable state (which reads the LIVE backend — dirty) and Kafka Streams
Interactive Queries' standby replicas (which serve committed store state);
this replica is the latter with an explicit consistency tag: every answer
carries the checkpoint id it reflects plus the replica's current lag.

Sharding mirrors the job's own state layout:

- a parallelism-P writer produces one replica shard per subtask, carrying
  the subtask's key-group range (``compute_key_group_range``), and a query
  routes to the owning shard **exactly like a record does** (murmur key
  group -> contiguous range — ``view.route_keys``);
- a mesh-sharded writer's slices become one replica shard per mesh shard,
  carrying the manifest's key-group range and row range (slot-range tiled,
  so lookups scan slices — the mesh routes records by slot block, not by
  key-group hash).

Catch-up on restore/rescale is manifest-driven and automatic: every ingest
replaces the shard set wholesale with whatever layout the checkpoint
carries, so a job rescaled from 4 shards to 2 (or to parallelism 3)
re-shards the replica at its next completed checkpoint — any mesh size,
either direction.  A topology change is counted in ``catch_ups``.

Staleness is first-class: ``queryable.replica_lag_checkpoints`` (completed
checkpoints newer than the one being served) and ``queryable.replica_lag_ms``
(how long the replica has been behind) are exported as gauges and returned
in every lookup's tags — a partitioned replica keeps serving at its
advertised staleness instead of failing, and re-converges after heal.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.core.functions import host_result
from flink_tpu_torch.queryable.view import (_Segment, coerce_keys, plain,
                                            route_keys)
from flink_tpu_torch.state.shard_layout import LAYOUT_KEY, SLICES_KEY
from flink_tpu_torch.testing import chaos
from flink_tpu_torch.utils import clock

#: fault point of the replica's bulk checkpoint fetch (the data plane the
#: stale-replica nemeses cut): ``Partition(direction="storage->replica")``
#: blackholes fetches while the metadata listing stays visible — the
#: replica keeps serving, lag gauges grow, heal re-converges
REPLICA_FETCH_POINT = "queryable.replica_fetch"


class QueryableStateSpec:
    """How to interpret one registered state's keyed snapshot: the
    aggregate's ACC spec + combine kinds (to merge retained panes) and its
    result function (ACC -> emitted value)."""

    def __init__(self, name: str, uid: str, key_column: str, agg,
                 output_column: str = "result"):
        self.name = name
        self.uid = uid
        self.key_column = key_column
        self.output_column = output_column
        self.agg = agg
        self.acc_spec = agg.acc_spec()
        self.kinds = agg.scatter_kind_leaves()

    @classmethod
    def from_operator(cls, name: str, uid: str, op) -> "QueryableStateSpec":
        return cls(name, uid, op.key_column, op.agg,
                   output_column=op.output_column)

    def result_columns(self, combined_leaves: List[np.ndarray]
                       ) -> Dict[str, np.ndarray]:
        acc = self.acc_spec.unflatten(combined_leaves)
        try:
            result = self.agg.host_get_result(acc)
        except (AttributeError, NotImplementedError):
            result = host_result(self.agg, self.acc_spec, combined_leaves)
        if isinstance(result, dict):
            return {c: np.asarray(v) for c, v in result.items()}
        return {self.output_column: np.asarray(result)}


class ReplicaShard:
    """One shard's pre-combined keyed rows + its manifest metadata."""

    __slots__ = ("index", "key_groups", "row_range", "rows", "n_keys")

    def __init__(self, index: int, key_groups: Tuple[int, int],
                 row_range: Optional[Tuple[int, int]], keys: np.ndarray,
                 cols: Dict[str, np.ndarray]):
        self.index = index
        self.key_groups = key_groups
        self.row_range = row_range
        self.n_keys = int(len(keys))
        # reuse the live view's frozen columnar index (lazy sort/dict)
        self.rows = _Segment(0, 0, keys, cols, 0, None)

    def manifest(self) -> Dict[str, Any]:
        return {"shard": self.index, "key_groups": list(self.key_groups),
                "row_range": (list(self.row_range)
                              if self.row_range is not None else None),
                "keys": self.n_keys}


def _is_keyed(tree: Dict[str, Any]) -> bool:
    # dense gid-indexed ("counts") or mesh per-shard-slice layout
    return "key_index" in tree and ("counts" in tree or SLICES_KEY in tree)


def _find_keyed_snapshot(tree) -> Optional[Dict[str, Any]]:
    """Locate the keyed window state inside a subtask snapshot (the chain
    wraps members as ``{"operator": {"op0": ...}}``; channel-state and
    source sections ride alongside)."""
    if isinstance(tree, dict):
        if _is_keyed(tree):
            return tree
        if "operator" in tree:
            got = _find_keyed_snapshot(tree["operator"])
            if got is not None:
                return got
        for v in tree.values():
            if isinstance(v, dict) and _is_keyed(v):
                return v
        for v in tree.values():
            if isinstance(v, dict):
                got = _find_keyed_snapshot(v)
                if got is not None:
                    return got
    return None


def _restore_keys(snap: Dict[str, Any]) -> np.ndarray:
    """Slot-ordered raw keys from a keyed snapshot's key-index section, in
    the dtype its index kind holds. The table is the index's ``reverse``
    as either package writes it (``interop.py`` reads JAX's object keys,
    tuples included), so no hash table is rebuilt to read it back."""
    from flink_tpu_torch.interop import _key_reverse
    return _key_reverse(snap["key_index"]["reverse"],
                        snap.get("key_index_kind", "KeyIndex"), "checkpoint")


class CheckpointReplica:
    """Sharded read replica of ONE registered state, fed by the checkpoint
    stream — either pushed (:meth:`ingest_assembled`, the in-process
    MiniCluster feed) or pulled (:meth:`start_tailing` a checkpoint
    storage, the cross-process deployment)."""

    def __init__(self, spec: QueryableStateSpec, storage=None,
                 poll_interval_s: float = 0.25, max_parallelism: int = 128,
                 name: Optional[str] = None):
        self.spec = spec
        #: replica identity — distinguishes fan-out siblings in chaos
        #: scoping (``Partition(replica=...)``) and in the staleness stats
        self.name = name or spec.name
        self.storage = storage
        self.poll_interval_s = poll_interval_s
        self.max_parallelism = max_parallelism
        self._lock = threading.Lock()
        self._shards: Tuple[ReplicaShard, ...] = ()
        self._parallelism = 0            # writer parallelism (subtask shards)
        self._serving_cid: Optional[int] = None
        self._serving_since_ms: Optional[int] = None
        self._advertised: set = set()    # completed cids seen advertised
        self._ingests = 0
        self._catch_ups = 0
        self._fetch_errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- feeding
    def observe_completed(self, checkpoint_id: int) -> None:
        """Advertise a completed checkpoint WITHOUT its payload: the lag
        gauges count advertised-but-not-served checkpoints."""
        with self._lock:
            if self._serving_cid is None or checkpoint_id > self._serving_cid:
                self._advertised.add(int(checkpoint_id))

    def ingest_assembled(self, checkpoint_id: int,
                         assembled: Dict[str, Any]) -> bool:
        """Build the shard set from one assembled checkpoint
        (``{uid: {"subtasks": [...]}}``).  Returns False when the
        checkpoint carries no keyed state for the registered uid (e.g. a
        checkpoint taken before the operator saw data)."""
        import time as _time

        from flink_tpu_torch.observability import tracing
        t0 = _time.perf_counter_ns()
        ok = self._ingest_assembled(checkpoint_id, assembled)
        tracing.complete("queryable.replica_ingest", t0,
                         _time.perf_counter_ns(), cat="queryable",
                         replica=self.name, checkpoint=int(checkpoint_id),
                         ingested=bool(ok))
        return ok

    def _ingest_assembled(self, checkpoint_id: int,
                          assembled: Dict[str, Any]) -> bool:
        self.observe_completed(checkpoint_id)
        entry = assembled.get(self.spec.uid)
        if entry is None:
            # uid not found verbatim: tolerate chained/prefixed uids
            for uid, val in assembled.items():
                if isinstance(val, dict) and str(self.spec.uid) in str(uid):
                    entry = val
                    break
        if not isinstance(entry, dict):
            return False
        sub_snaps = entry.get("subtasks", [entry])
        shards: List[ReplicaShard] = []
        for i, sub in enumerate(sub_snaps):
            keyed = _find_keyed_snapshot(sub)
            if keyed is None:
                # a subtask that saw no records yet has no key index — it
                # still OWNS its key-group range, so the ROUTING
                # parallelism below stays len(sub_snaps) (routing with a
                # keyed-only count would send its neighbours' keys to the
                # wrong shard)
                continue
            shards.extend(self._shards_of(i, len(sub_snaps), keyed))
        with self._lock:
            old_topo = tuple((s.index, s.key_groups, s.row_range is not None)
                             for s in self._shards)
            new_topo = tuple((s.index, s.key_groups, s.row_range is not None)
                             for s in shards)
            if self._shards and old_topo != new_topo:
                self._catch_ups += 1     # restore/rescale: re-sharded
            self._shards = tuple(shards)
            self._parallelism = max(len(sub_snaps), 1)
            self._serving_cid = int(checkpoint_id)
            self._serving_since_ms = clock.now_ms()
            self._ingests += 1
            # ids at or below the serving point can never contribute to
            # lag again: prune so the advertised set (and the lag scan
            # under this lock) stays O(lag), not O(lifetime checkpoints)
            self._advertised = {c for c in self._advertised
                                if c > self._serving_cid}
        return bool(shards)

    def _shards_of(self, subtask: int, parallelism: int,
                   keyed: Dict[str, Any]) -> List[ReplicaShard]:
        from flink_tpu_torch.core.keygroups import compute_key_group_range
        keys = _restore_keys(keyed)
        if SLICES_KEY in keyed:
            # mesh writer: one replica shard per slice, manifest-driven
            out = []
            for s in sorted(keyed[SLICES_KEY], key=lambda s: s["shard"]):
                lo, hi = s["row_range"]
                cols, live = self._combine(np.asarray(s["counts"]),
                                           [np.asarray(l)
                                            for l in s["leaves"]])
                out.append(ReplicaShard(
                    int(s["shard"]), tuple(s["key_groups"]), (int(lo),
                                                              int(hi)),
                    keys[lo:hi][live], cols))
            return out
        counts = np.asarray(keyed["counts"])
        leaves = [np.asarray(l) for l in keyed["leaves"]] \
            if "leaves" in keyed else []
        if counts.size == 0 or not leaves:
            cols: Dict[str, np.ndarray] = {}
            live = np.zeros(0, np.int64)
            keys = keys[:0]
        else:
            cols, live = self._combine(counts, leaves)
            keys = keys[: counts.shape[0]][live]
        kg = compute_key_group_range(self.max_parallelism, parallelism,
                                     subtask)
        return [ReplicaShard(subtask, (kg.start, kg.end), None, keys, cols)]

    def _combine(self, counts: np.ndarray, leaves: List[np.ndarray]
                 ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Merge retained panes per key (identity cells are no-ops by
        construction) and evaluate the aggregate's result — the same pane
        combine a host-tier fire runs.  Returns (result columns over LIVE
        keys, live-row index)."""
        from flink_tpu_torch.core.functions import SCATTER_UFUNCS
        total = counts.sum(axis=1)
        live = np.flatnonzero(total > 0)
        combined = []
        for kind, leaf in zip(self.spec.kinds, leaves):
            ufunc = SCATTER_UFUNCS[kind]
            combined.append(ufunc.reduce(leaf[live], axis=1))
        cols = self.spec.result_columns(combined) if live.size else {}
        return cols, live

    # ------------------------------------------------------------- tailing
    def start_tailing(self) -> "CheckpointReplica":
        """Poll the checkpoint storage for new completed checkpoints on a
        daemon thread (the cross-process feed).  The metadata listing
        (``checkpoint_ids``) always runs — lag stays advertised — while the
        bulk fetch fires :data:`REPLICA_FETCH_POINT` first, so partition/
        slow-disk nemeses act on the data plane only."""
        if self.storage is None:
            raise ValueError("start_tailing needs a checkpoint storage")
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._tail_loop,
                                        name=f"replica-{self.spec.name}",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
            self._thread = None

    def poll_once(self) -> bool:
        """One tail round: advertise the head, fetch+ingest if behind.
        Returns True when an ingest happened."""
        try:
            ids = self.storage.checkpoint_ids()
        except Exception:  # noqa: BLE001 — listing flake: retry next round
            return False
        for cid in ids:
            self.observe_completed(cid)
        if not ids:
            return False
        head = max(ids)
        with self._lock:
            if self._serving_cid is not None and head <= self._serving_cid:
                return False
        if not chaos.fire(REPLICA_FETCH_POINT, checkpoint_id=head,
                          direction="storage->replica",
                          replica=self.name):
            return False                 # partitioned: keep serving stale
        try:
            snap = self.storage.load(head)
        except Exception:  # noqa: BLE001 — fetch flake/corruption: the
            self._fetch_errors += 1      # replica keeps serving, retries
            return False
        return self.ingest_assembled(head, snap)

    def _tail_loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the tailer must survive
                self._fetch_errors += 1

    # ------------------------------------------------------------- queries
    def lookup_batch(self, keys) -> Tuple[np.ndarray,
                                          List[Optional[Dict[str, Any]]],
                                          Dict[str, Any]]:
        keys = coerce_keys(keys)
        with self._lock:
            shards = self._shards
            parallelism = self._parallelism
        n = len(keys)
        found = np.zeros(n, bool)
        values: List[Optional[Dict[str, Any]]] = [None] * n
        if shards:
            sliced = any(s.row_range is not None for s in shards)
            if not sliced and parallelism > 1:
                # hash-partitioned writer: route to the owning shard exactly
                # like a record (key group -> contiguous range)
                owner = route_keys(keys, parallelism, self.max_parallelism)
                by_subtask = {s.index: s for s in shards}
                for sub in np.unique(owner).tolist():
                    shard = by_subtask.get(int(sub))
                    if shard is None:
                        continue
                    sel = np.flatnonzero(owner == sub)
                    self._serve(shard, keys, sel, found, values)
            else:
                # slot-range tiled slices (mesh writer) or parallelism 1:
                # scan shards; a key lives in exactly one
                for shard in shards:
                    pending = np.flatnonzero(~found)
                    if pending.size == 0:
                        break
                    self._serve(shard, keys, pending, found, values)
        return found, values, self.tags()

    @property
    def epoch(self) -> Optional[int]:
        """Content version for the hot-key response cache: the serving
        checkpoint id (cache entries die the moment a newer checkpoint is
        ingested — the invalidation contract)."""
        return self._serving_cid

    def lookup_batch_columnar(self, keys) -> Tuple[np.ndarray,
                                                   Dict[str, np.ndarray],
                                                   Dict[str, Any]]:
        """Binary-wire twin of :meth:`lookup_batch`: dense result columns
        gathered per shard with zero per-key Python objects."""
        keys = coerce_keys(keys)
        with self._lock:
            shards = self._shards
            parallelism = self._parallelism
        n = len(keys)
        found = np.zeros(n, bool)
        cols: Dict[str, np.ndarray] = {}
        if shards:
            sliced = any(s.row_range is not None for s in shards)
            if not sliced and parallelism > 1:
                owner = route_keys(keys, parallelism, self.max_parallelism)
                by_subtask = {s.index: s for s in shards}
                for sub in np.unique(owner).tolist():
                    shard = by_subtask.get(int(sub))
                    if shard is None:
                        continue
                    sel = np.flatnonzero(owner == sub)
                    self._serve_columnar(shard, keys, sel, found, cols)
            else:
                for shard in shards:
                    pending = np.flatnonzero(~found)
                    if pending.size == 0:
                        break
                    self._serve_columnar(shard, keys, pending, found, cols)
        return found, cols, self.tags()

    @staticmethod
    def _serve_columnar(shard: ReplicaShard, keys: np.ndarray,
                        sel: np.ndarray, found: np.ndarray,
                        cols: Dict[str, np.ndarray]) -> None:
        idx = shard.rows.locate(np.asarray(keys)[sel])
        hit = idx >= 0
        if not hit.any():
            return
        qsel = sel[hit]
        rows = idx[hit]
        n = len(keys)
        for c, a in shard.rows.cols.items():
            out = cols.get(c)
            if out is None:
                out = cols[c] = (np.empty(n, object)
                                 if a.dtype.kind == "O"
                                 else np.zeros(n, a.dtype))
            got = a[rows]
            out[qsel] = got if out.dtype == a.dtype \
                else got.astype(out.dtype)
        found[qsel] = True

    @staticmethod
    def _serve(shard: ReplicaShard, keys: np.ndarray, sel: np.ndarray,
               found: np.ndarray, values: List) -> None:
        idx = shard.rows.locate(np.asarray(keys)[sel])
        hit = idx >= 0
        if not hit.any():
            return
        for qi, row in zip(sel[hit].tolist(), idx[hit].tolist()):
            values[qi] = {c: plain(a[row])
                          for c, a in shard.rows.cols.items()}
            found[qi] = True

    def tags(self) -> Dict[str, Any]:
        with self._lock:
            lag = self._lag_locked()
            return {"consistency": "checkpoint",
                    "checkpoint_id": self._serving_cid,
                    "replica_lag_checkpoints": lag,
                    "replica_lag_ms": self._lag_ms_locked(lag)}

    def _lag_locked(self) -> int:
        # the set is pruned to ids > serving at every ingest/observe
        return len(self._advertised)

    def _lag_ms_locked(self, lag: int) -> float:
        if lag <= 0 or self._serving_since_ms is None:
            return 0.0
        return float(max(0, clock.now_ms() - self._serving_since_ms))

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            lag = self._lag_locked()
            return {
                "serving_checkpoint_id": self._serving_cid,
                "advertised_pending_checkpoints": len(self._advertised),
                "replica_lag_checkpoints": lag,
                "replica_lag_ms": self._lag_ms_locked(lag),
                "ingests": self._ingests,
                "catch_ups": self._catch_ups,
                "fetch_errors": self._fetch_errors,
                "keys": sum(s.n_keys for s in self._shards),
                "shards": [s.manifest() for s in self._shards],
            }


class ReplicaGroup:
    """N-replica read fan-out for ONE state: reads load-balance
    across member :class:`CheckpointReplica` instances and always prefer
    the FRESHEST members — a member partitioned from the checkpoint stream
    (or simply behind) sees its traffic fail over to a sibling without a
    single read error, and the staleness stats NAME the laggards so the
    lag gauge points at the dead replica, not at an average.

    The group answers the exact replica interface the registry, the feed
    thread, and the wire layer already speak (``observe_completed`` /
    ``ingest_assembled`` / ``lookup_batch[{_columnar}]`` / ``tags`` /
    ``stats`` / ``start_tailing`` / ``stop``), so one registered entry is
    transparently one replica or N."""

    def __init__(self, members: List[CheckpointReplica]):
        if not members:
            raise ValueError("ReplicaGroup needs at least one member")
        self.members = list(members)
        # member names must be unique: the stats/laggards surface is
        # name-keyed, and chaos scoping (Partition(replica=...)) targets
        # by name — suffix duplicates (the CheckpointReplica default name
        # is the state name for every member)
        seen: Dict[str, int] = {}
        for m in self.members:
            n = seen.get(m.name, 0)
            seen[m.name] = n + 1
            if n:
                m.name = f"{m.name}#r{n}"
        self._rr = 0
        self._lock = threading.Lock()

    @property
    def spec(self):
        return self.members[0].spec

    # ---------------------------------------------------------------- feed
    def observe_completed(self, checkpoint_id: int) -> None:
        for m in self.members:
            m.observe_completed(checkpoint_id)

    def ingest_assembled(self, checkpoint_id: int,
                         assembled: Dict[str, Any]) -> bool:
        ok = False
        for m in self.members:
            ok = m.ingest_assembled(checkpoint_id, assembled) or ok
        return ok

    def start_tailing(self) -> "ReplicaGroup":
        for m in self.members:
            m.start_tailing()
        return self

    def stop(self) -> None:
        for m in self.members:
            m.stop()

    # -------------------------------------------------------------- queries
    def _pick(self) -> CheckpointReplica:
        """Freshest-first load balancing: candidates are the members
        serving the newest checkpoint id (None = never ingested sorts
        last); ties rotate round-robin so read load spreads evenly across
        the healthy siblings."""
        best: List[CheckpointReplica] = []
        best_cid = None
        for m in self.members:
            cid = m.epoch
            rank = -1 if cid is None else int(cid)
            if best_cid is None or rank > best_cid:
                best_cid, best = rank, [m]
            elif rank == best_cid:
                best.append(m)
        with self._lock:
            self._rr += 1
            return best[self._rr % len(best)]

    @property
    def epoch(self) -> Optional[int]:
        return self._pick_epoch()

    def _pick_epoch(self) -> Optional[int]:
        cids = [m.epoch for m in self.members if m.epoch is not None]
        return max(cids) if cids else None

    def lookup_batch(self, keys):
        return self._pick().lookup_batch(keys)

    def lookup_batch_columnar(self, keys):
        return self._pick().lookup_batch_columnar(keys)

    def tags(self) -> Dict[str, Any]:
        return self._pick().tags()

    # -------------------------------------------------------------- surface
    def stats(self) -> Dict[str, Any]:
        """The freshest member's serving view (what reads actually see),
        plus per-member staleness and the NAMES of the members lagging
        behind it — the failover observability contract."""
        per = {m.name: m.stats() for m in self.members}
        head = self._pick_epoch()
        laggards = sorted(
            m.name for m in self.members
            if head is not None and (m.epoch is None or m.epoch < head))
        serving = self._pick().stats()
        out = dict(serving)
        out["replicas"] = len(self.members)
        out["members"] = per
        out["laggards"] = laggards
        return out

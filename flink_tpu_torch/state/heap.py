"""Heap keyed-state backend: dense, batched, snapshot-rescalable (port of
``flink_tpu/state/heap.py``).

Analog of ``runtime/state/heap/HeapKeyedStateBackend.java`` +
``CopyOnWriteStateMap.java`` redesigned for batched execution: instead of a
chained hash map probed per record, each state is a **dense row table**
indexed by the backend's key slot ids (``state/keyindex.py``) —
numeric states are growable numpy arrays (promotable to device HBM), object
states are object arrays.  All hot-path access is vectorized
(``get_rows``/``put_rows``/``add_rows``); the scalar current-key accessors
exist for host-side user code parity with the reference API.

Snapshots are plain numpy trees in the repo-wide keyed-snapshot format
(``key_index`` + per-state row fields), so key-group splitting / merging on
rescale reuses ``state/redistribute.py`` unchanged — the analog of
``StateAssignmentOperation.reDistributeKeyedStates`` (SURVEY §5.3).

Snapshot isolation (the reference's COW snapshot, ``CopyOnWriteStateMap.java:48``)
falls out of numpy value semantics: ``snapshot()`` copies row arrays, so
processing can continue while the async uploader drains the snapshot.

The rows stay numpy on the host, as JAX's do: no state of this module lives
on a device.  The port's aggregates compute on tensors, so an aggregating
state converts at the aggregate's boundary (``lift``, ``combine_leaves``,
``get_result``) and keeps every dtype; the folds themselves are the same
numpy calls as JAX's.  Keys go through ``state/keyindex.py``
``make_key_index``: integer keys take the C keydict, other keys an
``ObjectKeyIndex``.  A snapshot names its index as JAX's does
(``"KeyIndex"`` or ``"ObjectKeyIndex"``), so either package restores the
other's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.core.functions import (SCATTER_UFUNCS, combine_rows,
                                            host_result, to_numpy, to_tensors,
                                            tree_leaves)
from flink_tpu_torch.state import api as state_api
from flink_tpu_torch.state.api import (AggregatingState,
                                       AggregatingStateDescriptor, ListState,
                                       MapState, ReducingState,
                                       StateDescriptor, StateTtlConfig,
                                       UpdateType, ValueState)
from flink_tpu_torch.state.evolution import (AFTER_MIGRATION, INCOMPATIBLE,
                                             SchemaEvolutionError,
                                             acc_leaf_schema,
                                             migrate_acc_leaves,
                                             resolve_compatibility,
                                             schema_of_backend,
                                             schema_of_descriptor)
from flink_tpu_torch.state.keyindex import (key_index_kind, make_key_index,
                                            restore_key_index)
from flink_tpu_torch.utils import clock

_ABSENT = -1


def _now_ms() -> int:
    """TTL's default clock: the clock seam's wall clock in ms
    (``utils/clock.py``), so a chaos skew schedule steers expiry.  Backends
    read it at each call, so a test may also patch this module's
    ``_now_ms``."""
    return clock.now_ms()


def _segment_order_spans(slots: np.ndarray):
    """Group a slot array: returns (order, [(start, end, slot), ...]) where
    ``order`` stable-sorts rows by slot and spans index the sorted view —
    the one host-side group-by used by every append-style state."""
    order = np.argsort(slots, kind="stable")
    ss = slots[order]
    bounds = np.nonzero(np.concatenate([[True], ss[1:] != ss[:-1]]))[0]
    spans = [(int(b), int(bounds[i + 1]) if i + 1 < len(bounds) else len(ss),
              int(ss[b])) for i, b in enumerate(bounds)]
    return order, spans


class _TtlTracker:
    """Per-(state,slot) last-access timestamps + vectorized expiry filter."""

    def __init__(self, ttl: StateTtlConfig, clock: Callable[[], int]):
        self.ttl = ttl
        self._clock = clock
        self._ts = np.zeros(0, np.int64)

    def _ensure(self, n: int) -> None:
        if n > self._ts.size:
            new = np.zeros(max(n, max(16, self._ts.size * 2)), np.int64)
            new[: self._ts.size] = self._ts
            self._ts = new

    def touch(self, slots: np.ndarray) -> None:
        slots = np.asarray(slots)
        if slots.size:
            self._ensure(int(slots.max()) + 1)
            self._ts[slots] = self._clock()

    def touch_on_read(self, slots: np.ndarray) -> None:
        if self.ttl.update_type == UpdateType.OnReadAndWrite:
            self.touch(slots)

    def expired(self, slots: np.ndarray) -> np.ndarray:
        """bool[B]: True where the entry is past its TTL."""
        slots = np.asarray(slots)
        self._ensure(int(slots.max()) + 1 if slots.size else 0)
        cutoff = self._clock() - self.ttl.ttl_ms
        return self._ts[slots] < cutoff

    def expired_upto(self, n: int) -> np.ndarray:
        self._ensure(n)
        cutoff = self._clock() - self.ttl.ttl_ms
        return self._ts[:n] < cutoff

    def snapshot(self, n: int) -> np.ndarray:
        self._ensure(n)
        return self._ts[:n].copy()

    def restore(self, ts: np.ndarray) -> None:
        self._ts = np.asarray(ts, np.int64).copy()


class _HeapStateBase:
    def __init__(self, backend: "HeapKeyedStateBackend", desc: StateDescriptor):
        self._backend = backend
        self._desc = desc
        self._ttl: Optional[_TtlTracker] = (
            _TtlTracker(desc.ttl, backend._clock) if desc.ttl else None)

    @property
    def name(self) -> str:
        return self._desc.name

    def _slot(self) -> int:
        s = self._backend._current_slot
        if s < 0:
            raise RuntimeError(
                f"no current key set for state {self._desc.name!r} "
                "(call backend.set_current_key first)")
        return s

    def _alive(self, slots: np.ndarray, present: np.ndarray) -> np.ndarray:
        """present mask with TTL-expired rows masked out."""
        if self._ttl is None or self._ttl.ttl.visibility != \
                state_api.StateVisibility.NeverReturnExpired:
            return present
        return present & ~self._ttl.expired(slots)

    def _touch_write(self, slots: np.ndarray) -> None:
        if self._ttl is not None:
            self._ttl.touch(slots)

    def _purge_expired_before_append(self, slots: np.ndarray) -> None:
        """Appending into an expired entry must not resurrect the old
        content: clear expired slots before folding new values in (the
        reference's TTL decorators never merge into expired state)."""
        if self._ttl is None:
            return
        slots = np.unique(np.asarray(slots, np.int64))
        dead = slots[self._ttl.expired(slots)]
        if dead.size:
            self.clear_rows(dead)

    def _touch_read(self, slots: np.ndarray) -> None:
        if self._ttl is not None:
            self._ttl.touch_on_read(slots)

    # snapshot plumbing — subclasses fill "rows"
    def _snapshot_common(self, n: int, snap: Dict[str, Any]) -> Dict[str, Any]:
        if self._ttl is not None:
            snap["ttl_ts"] = self._ttl.snapshot(n)
            if self._ttl.ttl.cleanup_in_snapshot:
                # full-snapshot cleanup: drop expired rows from the snapshot
                snap["ttl_expired"] = self._ttl.expired_upto(n).copy()
        return snap


class _DenseGrow:
    """Growable dense [cap, *shape] array + present mask."""

    def __init__(self, dtype: np.dtype, shape: Tuple[int, ...], default):
        self.dtype, self.shape = dtype, shape
        self.default = default
        self.data = np.zeros((0,) + shape, dtype)
        self.present = np.zeros(0, bool)

    def ensure(self, n: int) -> None:
        if n > self.data.shape[0]:
            cap = max(n, max(16, self.data.shape[0] * 2))
            nd = np.zeros((cap,) + self.shape, self.dtype)
            nd[: self.data.shape[0]] = self.data
            np_p = np.zeros(cap, bool)
            np_p[: self.present.size] = self.present
            self.data, self.present = nd, np_p

    def default_rows(self, n: int) -> np.ndarray:
        out = np.zeros((n,) + self.shape, self.dtype)
        if self.default is not None:
            out[:] = self.default
        return out


class HeapValueState(ValueState, _HeapStateBase):
    """Dense numeric ValueState (numpy row table) or object ValueState."""

    def __init__(self, backend, desc: StateDescriptor):
        _HeapStateBase.__init__(self, backend, desc)
        self._dense = (_DenseGrow(desc.dtype, desc.shape, desc.default)
                       if desc.dtype is not None else None)
        self._objs: List[Any] = []
        self._obj_present = np.zeros(0, bool)

    # -- vectorized ---------------------------------------------------------
    def get_rows(self, slots: np.ndarray):
        slots = np.asarray(slots, np.int64)
        if self._dense is not None:
            self._dense.ensure(int(slots.max()) + 1 if slots.size else 0)
            alive = self._alive(slots, self._dense.present[slots])
            out = self._dense.data[slots].copy()
            if self._desc.default is not None:
                out[~alive] = self._desc.default
            else:
                out[~alive] = 0
            self._touch_read(slots)
            return out, alive
        vals = [self._objs[s] if (s < len(self._objs)) else None for s in slots]
        present = np.array([s < self._obj_present.size and self._obj_present[s]
                            for s in slots], bool)
        alive = self._alive(slots, present)
        self._touch_read(slots)
        return np.array([v if a else self._desc.default
                         for v, a in zip(vals, alive)], object), alive

    def put_rows(self, slots: np.ndarray, values) -> None:
        slots = np.asarray(slots, np.int64)
        if not slots.size:
            return
        n = int(slots.max()) + 1
        if self._dense is not None:
            self._dense.ensure(n)
            self._dense.data[slots] = np.asarray(values, self._dense.dtype)
            self._dense.present[slots] = True
        else:
            self._ensure_objs(n)
            for s, v in zip(slots, values):
                self._objs[s] = v
            self._obj_present[slots] = True
        self._touch_write(slots)

    def clear_rows(self, slots: np.ndarray) -> None:
        slots = np.asarray(slots, np.int64)
        if not slots.size:
            return
        if self._dense is not None:
            self._dense.ensure(int(slots.max()) + 1)
            self._dense.present[slots] = False
        else:
            self._ensure_objs(int(slots.max()) + 1)
            self._obj_present[slots] = False
            for s in slots:
                self._objs[s] = None

    def _ensure_objs(self, n: int) -> None:
        while len(self._objs) < n:
            self._objs.append(None)
        if n > self._obj_present.size:
            p = np.zeros(max(n, max(16, self._obj_present.size * 2)), bool)
            p[: self._obj_present.size] = self._obj_present
            self._obj_present = p

    # -- scalar (current key) ----------------------------------------------
    def value(self):
        vals, alive = self.get_rows(np.array([self._slot()]))
        return (vals[0] if alive[0] else self._desc.default)

    def update(self, value) -> None:
        self.put_rows(np.array([self._slot()]), [value])

    def clear(self) -> None:
        self.clear_rows(np.array([self._slot()]))

    # -- snapshot ------------------------------------------------------------
    def snapshot(self, n: int) -> Dict[str, Any]:
        if self._dense is not None:
            self._dense.ensure(n)
            snap = {"rows": self._dense.data[:n].copy(),
                    "present": self._dense.present[:n].copy()}
        else:
            self._ensure_objs(n)
            rows = np.empty(n, object)
            rows[:] = self._objs[:n]
            snap = {"rows": rows, "present": self._obj_present[:n].copy()}
        return self._snapshot_common(n, snap)

    def restore(self, snap: Dict[str, Any]) -> None:
        rows, present = snap["rows"], np.asarray(snap["present"], bool)
        if "ttl_expired" in snap:
            present = present & ~np.asarray(snap["ttl_expired"], bool)
        n = len(present)
        if self._dense is not None:
            self._dense.ensure(n)
            self._dense.data[:n] = rows
            self._dense.present[:n] = present
        else:
            self._ensure_objs(n)
            for i in range(n):
                self._objs[i] = rows[i]
            self._obj_present[:n] = present
        if self._ttl is not None and "ttl_ts" in snap:
            self._ttl.restore(snap["ttl_ts"])


class HeapListState(ListState, _HeapStateBase):
    """Per-slot Python list (object path).  ``add_rows`` appends a whole batch
    grouped by slot in one argsort pass (no per-record dict probing)."""

    def __init__(self, backend, desc: StateDescriptor):
        _HeapStateBase.__init__(self, backend, desc)
        self._lists: List[Optional[list]] = []

    def _ensure(self, n: int) -> None:
        while len(self._lists) < n:
            self._lists.append(None)

    def add_rows(self, slots: np.ndarray, values) -> None:
        slots = np.asarray(slots, np.int64)
        if not slots.size:
            return
        self._ensure(int(slots.max()) + 1)
        self._purge_expired_before_append(slots)
        order, spans = _segment_order_spans(slots)
        vals = np.asarray(values, object)[order]
        for b, e, s in spans:
            if self._lists[s] is None:
                self._lists[s] = []
            self._lists[s].extend(vals[b:e].tolist())
        self._touch_write(np.unique(slots))

    def get_rows(self, slots: np.ndarray) -> List[list]:
        slots = np.asarray(slots, np.int64)
        self._ensure(int(slots.max()) + 1 if slots.size else 0)
        present = np.array([self._lists[s] is not None for s in slots], bool)
        alive = self._alive(slots, present)
        self._touch_read(slots)
        return [list(self._lists[s]) if a else []
                for s, a in zip(slots, alive)]

    def get(self) -> list:
        return self.get_rows(np.array([self._slot()]))[0]

    def add(self, value) -> None:
        self.add_rows(np.array([self._slot()]), [value])

    def update(self, values) -> None:
        s = self._slot()
        self._ensure(s + 1)
        self._lists[s] = list(values)
        self._touch_write(np.array([s]))

    def clear(self) -> None:
        s = self._slot()
        self._ensure(s + 1)
        self._lists[s] = None

    def clear_rows(self, slots: np.ndarray) -> None:
        slots = np.asarray(slots, np.int64)
        if slots.size:
            self._ensure(int(slots.max()) + 1)
            for s in slots:
                self._lists[s] = None

    def snapshot(self, n: int) -> Dict[str, Any]:
        self._ensure(n)
        rows = np.empty(n, object)
        rows[:] = [None if l is None else list(l) for l in self._lists[:n]]
        return self._snapshot_common(n, {"rows": rows})

    def restore(self, snap: Dict[str, Any]) -> None:
        rows = snap["rows"]
        expired = snap.get("ttl_expired")
        self._lists = [
            None if (r is None or (expired is not None and expired[i]))
            else list(r)
            for i, r in enumerate(rows)]
        if self._ttl is not None and "ttl_ts" in snap:
            self._ttl.restore(snap["ttl_ts"])


class HeapMapState(MapState, _HeapStateBase):
    def __init__(self, backend, desc: StateDescriptor):
        _HeapStateBase.__init__(self, backend, desc)
        self._maps: List[Optional[dict]] = []

    def _ensure(self, n: int) -> None:
        while len(self._maps) < n:
            self._maps.append(None)

    def clear_rows(self, slots: np.ndarray) -> None:
        slots = np.asarray(slots, np.int64)
        if slots.size:
            self._ensure(int(slots.max()) + 1)
            for s in slots:
                self._maps[s] = None

    def _map(self, create: bool = False) -> Optional[dict]:
        s = self._slot()
        self._ensure(s + 1)
        if create and self._maps[s] is not None and self._ttl is not None \
                and self._ttl.expired(np.array([s]))[0]:
            self._maps[s] = None  # writing into an expired map starts fresh
        if self._maps[s] is None and create:
            self._maps[s] = {}
        if self._maps[s] is not None:
            arr = np.array([s])
            if create:
                self._touch_write(arr)
            else:
                alive = self._alive(arr, np.array([True]))
                if not alive[0]:
                    self._maps[s] = None
                    return None
                self._touch_read(arr)
        return self._maps[s]

    def get(self, key):
        m = self._map()
        return None if m is None else m.get(key)

    def put(self, key, value) -> None:
        self._map(create=True)[key] = value

    def remove(self, key) -> None:
        m = self._map()
        if m is not None:
            m.pop(key, None)

    def contains(self, key) -> bool:
        m = self._map()
        return m is not None and key in m

    def items(self):
        m = self._map()
        return [] if m is None else list(m.items())

    def clear(self) -> None:
        s = self._slot()
        self._ensure(s + 1)
        self._maps[s] = None

    def maps_rows(self, slots: np.ndarray) -> List[Optional[dict]]:
        slots = np.asarray(slots, np.int64)
        self._ensure(int(slots.max()) + 1 if slots.size else 0)
        return [self._maps[s] for s in slots]

    def snapshot(self, n: int) -> Dict[str, Any]:
        self._ensure(n)
        rows = np.empty(n, object)
        rows[:] = [None if m is None else dict(m) for m in self._maps[:n]]
        return self._snapshot_common(n, {"rows": rows})

    def restore(self, snap: Dict[str, Any]) -> None:
        rows = snap["rows"]
        expired = snap.get("ttl_expired")
        self._maps = [
            None if (r is None or (expired is not None and expired[i]))
            else dict(r)
            for i, r in enumerate(rows)]
        if self._ttl is not None and "ttl_ts" in snap:
            self._ttl.restore(snap["ttl_ts"])


class HeapAggregatingState(AggregatingState, _HeapStateBase):
    """Dense ACC rows per slot; the batched analog of
    ``HeapAggregatingState.java:42``.  ``add_rows`` folds a whole batch with
    numpy ufunc scatters (add/min/max fast path) or a sort+reduce fold for
    arbitrary monoids — mirroring the device kernels in
    ``ops/scatter.py`` on the host tier."""

    def __init__(self, backend, desc: AggregatingStateDescriptor):
        _HeapStateBase.__init__(self, backend, desc)
        self.agg = desc.agg
        spec = self.agg.acc_spec()
        self._spec = spec
        self._leaves = [np.zeros((0,) + s, d)
                        for s, d in zip(spec.leaf_shapes, spec.leaf_dtypes)]
        self._present = np.zeros(0, bool)
        self._kinds = self.agg.scatter_kind_leaves()

    def _ensure(self, n: int) -> None:
        if n > self._present.size:
            cap = max(n, max(16, self._present.size * 2))
            new_leaves = []
            for leaf, init in zip(self._leaves, self._spec.leaf_inits):
                nd = np.empty((cap,) + leaf.shape[1:], leaf.dtype)
                nd[:] = init
                nd[: leaf.shape[0]] = leaf
                new_leaves.append(nd)
            self._leaves = new_leaves
            p = np.zeros(cap, bool)
            p[: self._present.size] = self._present
            self._present = p

    def add_rows(self, slots: np.ndarray, values) -> None:
        slots = np.asarray(slots, np.int64)
        if not slots.size:
            return
        self._ensure(int(slots.max()) + 1)
        self._purge_expired_before_append(slots)
        # the aggregate lifts tensors: numpy in, numpy out, dtypes kept
        lifted = [np.asarray(l) for l in
                  tree_leaves(to_numpy(self.agg.lift(to_tensors(values))))]
        if self._kinds is not None:
            for leaf, l, kind in zip(self._leaves, lifted, self._kinds):
                SCATTER_UFUNCS[kind].at(leaf, slots, l.astype(leaf.dtype))
        else:
            order, spans = _segment_order_spans(slots)
            sv = [l[order] for l in lifted]
            for b, e, s in spans:
                acc = tuple(leaf[s] for leaf in self._leaves)
                for j in range(b, e):
                    acc = combine_rows(self.agg, acc,
                                       tuple(l[j] for l in sv))
                for leaf, a in zip(self._leaves, acc):
                    leaf[s] = a
        self._present[slots] = True
        self._touch_write(np.unique(slots))

    def get_rows(self, slots: np.ndarray):
        """Returns (results, alive): vectorized get_result over slots.
        Results are an array for scalar-valued aggregates, or a dict of
        arrays for composite results (e.g. TupleAggregator)."""
        slots = np.asarray(slots, np.int64)
        self._ensure(int(slots.max()) + 1 if slots.size else 0)
        alive = self._alive(slots, self._present[slots])
        res = host_result(self.agg, self._spec,
                          [leaf[slots] for leaf in self._leaves])
        self._touch_read(slots)
        if isinstance(res, dict):
            return {k: np.asarray(v) for k, v in res.items()}, alive
        return np.asarray(res), alive

    def get(self):
        res, alive = self.get_rows(np.array([self._slot()]))
        if isinstance(res, dict):
            # composite result (dict-ACC aggregates): one row -> one dict
            return ({k: v[0].item() if hasattr(v[0], "item") else v[0]
                     for k, v in res.items()} if alive[0] else None)
        return res[0] if alive[0] else None

    def add(self, value) -> None:
        self.add_rows(np.array([self._slot()]), np.asarray([value]))

    def clear(self) -> None:
        self.clear_rows(np.array([self._slot()]))

    def clear_rows(self, slots: np.ndarray) -> None:
        slots = np.asarray(slots, np.int64)
        if not slots.size:
            return
        self._ensure(int(slots.max()) + 1)
        for leaf, init in zip(self._leaves, self._spec.leaf_inits):
            leaf[slots] = init
        self._present[slots] = False

    def snapshot(self, n: int) -> Dict[str, Any]:
        self._ensure(n)
        return self._snapshot_common(n, {
            "rows": tuple(leaf[:n].copy() for leaf in self._leaves),
            "leaf_schema": acc_leaf_schema(self._spec),
            "present": self._present[:n].copy()})

    def restore(self, snap: Dict[str, Any]) -> None:
        present = np.asarray(snap["present"], bool)
        if "ttl_expired" in snap:
            present = present & ~np.asarray(snap["ttl_expired"], bool)
        n = len(present)
        self._ensure(n)

        def fill(j, _n=n):
            init = np.asarray(self._spec.leaf_inits[j],
                              self._spec.leaf_dtypes[j])
            return np.broadcast_to(
                init, (_n,) + tuple(self._spec.leaf_shapes[j])).copy()

        rows = migrate_acc_leaves(snap["rows"], snap.get("leaf_schema"),
                                  self._spec, fill)
        for leaf, r in zip(self._leaves, rows):
            leaf[:n] = r
        self._present[:n] = present
        if self._ttl is not None and "ttl_ts" in snap:
            self._ttl.restore(snap["ttl_ts"])


class HeapReducingState(HeapAggregatingState, ReducingState):
    """ReducingState == AggregatingState whose ACC is the value type
    (``HeapReducingState.java`` analog)."""

    def __init__(self, backend, desc):
        agg_desc = AggregatingStateDescriptor(desc.name, desc.reduce_fn,
                                              ttl=desc.ttl)
        super().__init__(backend, agg_desc)


#: every field a state impl may put in its snapshot dict (restore parses
#: flattened "state.<name>.<field>" keys against this closed set)
_STATE_SNAPSHOT_FIELDS = ("rows", "present", "ttl_ts", "ttl_expired",
                          "leaf_schema")

_IMPLS = {
    "value": HeapValueState,
    "list": HeapListState,
    "map": HeapMapState,
    "reducing": HeapReducingState,
    "aggregating": HeapAggregatingState,
}


class HeapKeyedStateBackend:
    """Keyed state backend: owns the key→slot index and all named states.

    One backend per keyed operator subtask (as in the reference, one
    ``HeapKeyedStateBackend`` per ``AbstractStreamOperator``); the key slots
    it hands out double as row ids into every registered state table AND into
    the operator's device arrays — a single key universe per operator.
    """

    def __init__(self, max_parallelism: int = 128,
                 clock: Optional[Callable[[], int]] = None):
        self.max_parallelism = max_parallelism
        # None: the module's _now_ms, read at each call (tests patch it)
        self._clock = clock if clock is not None else (lambda: _now_ms())
        self._index = None       # NativeKeyIndex or ObjectKeyIndex
        self._states: Dict[str, _HeapStateBase] = {}
        self._descs: Dict[str, StateDescriptor] = {}
        self._pending_restore: Dict[str, Dict[str, Any]] = {}
        self._current_slot = _ABSENT

    # -- keys ----------------------------------------------------------------
    @property
    def num_keys(self) -> int:
        return 0 if self._index is None else self._index.num_keys

    def _ensure_index(self, sample_key):
        if self._index is None:
            self._index = make_key_index(sample_key)
        return self._index

    def key_slots(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized key -> dense slot (inserting new keys)."""
        keys = np.asarray(keys)
        if keys.size == 0:
            return np.zeros(0, np.int32)
        return self._ensure_index(keys[0]).lookup_or_insert(keys)

    def set_current_key(self, key) -> None:
        self._current_slot = int(self.key_slots(np.asarray([key]))[0])

    def current_slot(self) -> int:
        return self._current_slot

    def slot_keys(self, slots: np.ndarray) -> np.ndarray:
        """slot ids -> raw keys (for emitting results)."""
        rev = self._index.reverse_keys()
        return np.asarray(rev)[np.asarray(slots)]

    # -- states --------------------------------------------------------------
    def get_state(self, desc: StateDescriptor):
        """``getPartitionedState`` analog: create-or-return the named state."""
        st = self._states.get(desc.name)
        if st is None:
            st = _IMPLS[desc.kind](self, desc)
            self._states[desc.name] = st
            self._descs[desc.name] = desc
            pending = self._pending_restore.pop(desc.name, None)
            if pending is not None:
                # restored snapshot binds when the descriptor registers —
                # same contract as the reference's getPartitionedState.
                # Schema compatibility resolves HERE (the reference's
                # resolveSchemaCompatibility on first state access).
                pending = self._resolve_schema(desc, pending)
                st.restore(pending)
        return st

    def _resolve_schema(self, desc: StateDescriptor,
                        pending: Dict[str, Any]) -> Dict[str, Any]:
        old = getattr(self, "_restored_schema", {}).get(desc.name)
        if old is None:
            return pending
        new = schema_of_descriptor(desc)
        verdict = resolve_compatibility(old, new)
        if verdict == INCOMPATIBLE:
            raise SchemaEvolutionError(
                f"state {desc.name!r}: stored schema {old} cannot restore "
                f"into descriptor schema {new} (only widening migrations "
                f"are supported)")
        if verdict == AFTER_MIGRATION:
            target = np.dtype(new["dtype"])
            # ONLY the value rows migrate — bookkeeping fields (ttl_ts
            # timestamps, presence flags) keep their own dtypes
            pending = {
                f: (v.astype(target)
                    if f == "rows" and isinstance(v, np.ndarray)
                    and v.dtype != object
                    and np.issubdtype(v.dtype, np.number) else v)
                for f, v in pending.items()}
        return pending

    def value_state(self, name: str, **kw) -> HeapValueState:
        return self.get_state(state_api.ValueStateDescriptor(name, **kw))

    def list_state(self, name: str, **kw) -> HeapListState:
        return self.get_state(state_api.ListStateDescriptor(name, **kw))

    def map_state(self, name: str, **kw) -> HeapMapState:
        return self.get_state(state_api.MapStateDescriptor(name, **kw))

    def reducing_state(self, name: str, reduce_fn, **kw) -> HeapReducingState:
        return self.get_state(
            state_api.ReducingStateDescriptor(name, reduce_fn, **kw))

    def aggregating_state(self, name: str, agg, **kw) -> HeapAggregatingState:
        return self.get_state(
            state_api.AggregatingStateDescriptor(name, agg, **kw))

    # -- snapshot / restore --------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Repo-standard keyed snapshot: ``key_index`` + one row field per
        state, splittable by ``redistribute.split_keyed_snapshot``."""
        if self._index is None:
            return {"empty": True}
        n = self.num_keys
        snap: Dict[str, Any] = {
            "key_index": self._index.snapshot(),
            "key_index_kind": key_index_kind(self._index),
            "num_keys": n,
            "state_names": sorted(set(self._states) | set(self._pending_restore)),
        }
        for name, st in self._states.items():
            sub = st.snapshot(n)
            for f, v in sub.items():
                snap[f"state.{name}.{f}"] = v
        # restored states whose descriptor hasn't re-registered yet must be
        # carried through verbatim, or a restore→checkpoint cycle loses them
        for name, sub in self._pending_restore.items():
            for f, v in sub.items():
                snap[f"state.{name}.{f}"] = v
        # serializer-snapshot analog: per-state schema rides the checkpoint
        schema = schema_of_backend(self)
        # states restored-but-not-rebound keep their stored schema
        for name, s in getattr(self, "_restored_schema", {}).items():
            schema.setdefault(name, s)
        snap["__schema__"] = schema
        return snap

    @staticmethod
    def row_fields(snap: Dict[str, Any]) -> List[str]:
        """The per-key row fields of a backend snapshot (for redistribute).
        ``leaf_schema`` entries are per-STATE metadata, not per-key rows —
        splitting them by key group would corrupt them."""
        return [k for k in snap if k.startswith("state.")
                and not k.endswith(".leaf_schema")]

    def restore(self, snap: Dict[str, Any]) -> None:
        if snap.get("empty"):
            return
        self._restored_schema = dict(snap.get("__schema__", {}))
        self._index = restore_key_index(snap["key_index"],
                                        snap.get("key_index_kind", "KeyIndex"))
        for name in snap.get("state_names", []):
            # match against the KNOWN field suffixes so a state name
            # containing '.' (or one that prefixes another) parses correctly
            sub = {}
            for f in _STATE_SNAPSHOT_FIELDS:
                key = f"state.{name}.{f}"
                if key in snap:
                    sub[f] = snap[key]
            st = self._states.get(name)
            if st is None:
                self._pending_restore[name] = sub  # lazy-bind on registration
            else:
                st.restore(sub)

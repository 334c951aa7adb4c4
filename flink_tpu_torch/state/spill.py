"""The spill tier (port of ``flink_tpu/state/spill.py`` and of
``flink_tpu/native/__init__.py`` ``SpillStore``): keyed state and cold pane
cells in the port's C spill store (``csrc/spill_store.cc``), an in-memory
index with a byte budget that evicts, oldest write first, to an append-only
log on disk.

- :class:`SpillStore` is the key-value store: byte keys and values of any
  length, ``flush`` (the log fsynced, then an ``FSP1`` manifest, which a
  store opened in the same directory reads back), ``compact`` (the log
  rewritten with only the live spilled values; returns the bytes
  reclaimed).  There is no Python fallback: a store whose library does not
  build raises.
- :class:`SpillKeyedStateBackend` (``state.backend: spill``, the RocksDB
  backend's analog) keeps keyed state as one entry per (state, key slot):
  the key ``name + b"\\x00" + struct('<I', slot)``, the value
  ``pickle.dumps((ts, value))`` with numpy values, as JAX's, so snapshots
  cross packages both ways.  The key index stays in memory; values spill.
  Its surface is the heap backend's (key slots, ``get_state``, the
  repo-standard keyed snapshot), so ``KeyedProcessOperator`` and
  ``state/redistribute.py`` work on it unchanged.  TTL reads the clock seam
  (``utils/clock.py``) at each call unless a ``clock`` is given.
- :class:`PaneSpillStore` keeps serialized per-(key, pane) pane-ring cells
  for cold-key paging, under the key ``struct('<qq', gid, pane)``, with the
  JAX package's fixed value layout::

      u8  flags   (bit0 = emit-mirror bit)
      i64 count   (element count of the cell)
      raw leaf bytes, one fixed-size block per ACC leaf in DEVICE
      dtype/shape (spec.leaf_dtypes / spec.leaf_shapes order)

  Device dtypes on purpose: a key that pages out and back in continues its
  accumulation history bit for bit.  Besides the single-cell ``put`` /
  ``get`` / ``delete``, the ``*_many`` entries take whole arrays of cells
  in one C call, so a pager's work per batch is a few calls, not one per
  cell.

The aggregating states fold through the aggregate's tensor functions at
the boundary (:func:`to_tensors`, :func:`combine_rows`), numpy in and out,
dtypes kept, as the heap backend's do.
"""

from __future__ import annotations

import ctypes
import os
import pickle
import shutil
import struct
import tempfile
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple

import numpy as np

from flink_tpu_torch.core.functions import (SCATTER_UFUNCS, combine_rows,
                                            host_result, to_numpy,
                                            to_tensors, tree_leaves)
from flink_tpu_torch.state import api as state_api
from flink_tpu_torch.state.api import (AggregatingState,
                                       AggregatingStateDescriptor, ListState,
                                       MapState, ReducingState,
                                       ReducingStateDescriptor,
                                       StateDescriptor, ValueState)
from flink_tpu_torch.state.keyindex import (key_index_kind, make_key_index,
                                            restore_key_index)
from flink_tpu_torch.utils import clock as _clock_seam

_ABSENT = -1


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _release(lib, handle, owned_dir: Optional[str]) -> None:
    lib.ftt_spill_close(handle)
    if owned_dir is not None:
        shutil.rmtree(owned_dir, ignore_errors=True)


class PaneSpillStore:
    """Serialized (gid, pane) cells of the pane ring over the C spill store.

    ``directory`` holds the disk log (a fresh temporary directory when None,
    removed again by :meth:`close`); ``mem_budget`` is the resident value
    bytes before entries move to the log."""

    def __init__(self, directory: Optional[str] = None,
                 mem_budget: int = 64 << 20,
                 leaf_dtypes=(), leaf_shapes=()):
        from flink_tpu_torch.kernels.build import spill_store_lib
        lib = spill_store_lib()
        owned = None
        if directory is None:
            directory = owned = tempfile.mkdtemp(
                prefix="flink_tpu_torch_pages_")
        self.directory = directory
        self._lib = lib
        self._dtypes = [np.dtype(d) for d in leaf_dtypes]
        self._shapes = [tuple(s) for s in leaf_shapes]
        #: bytes of each leaf's block in a value
        self._leaf_bytes = np.asarray(
            [d.itemsize * int(np.prod(s, dtype=np.int64))
             for d, s in zip(self._dtypes, self._shapes)], np.int64)
        self._nl = len(self._dtypes)
        value_len = 9 + int(self._leaf_bytes.sum())   # u8 flags + i64 count
        self._h = lib.ftt_spill_open(directory.encode(), int(mem_budget),
                                     value_len)
        if not self._h:
            if owned is not None:
                shutil.rmtree(owned, ignore_errors=True)
            raise RuntimeError(f"spill store: cannot open a log in "
                               f"{directory}")
        self._close = weakref.finalize(self, _release, lib, self._h, owned)

    @property
    def closed(self) -> bool:
        return not self._close.alive

    def _handle(self):
        if self.closed:
            raise ValueError("spill store is closed")
        return self._h

    # -- array entries ---------------------------------------------------
    def _leaf_ptrs(self, arrays: Sequence[np.ndarray]):
        return (ctypes.c_void_p * max(self._nl, 1))(
            *[a.ctypes.data for a in arrays])

    def put_many(self, gids, panes, flags, counts,
                 leaves: Sequence[np.ndarray]) -> None:
        """Put cells ``i`` in order: key ``(gids[i], panes[i])``, value
        ``flags[i]``, ``counts[i]`` and row ``i`` of each ``[n, *leaf]``
        array of ``leaves`` (cast to the leaf's device dtype)."""
        gids = np.ascontiguousarray(gids, np.int64)
        n = gids.size
        panes = np.ascontiguousarray(np.broadcast_to(panes, (n,)), np.int64)
        flags = np.ascontiguousarray(np.broadcast_to(flags, (n,)), np.uint8)
        counts = np.ascontiguousarray(counts, np.int64).reshape(n)
        cols = [np.ascontiguousarray(np.asarray(v, d).reshape((n,) + s))
                for v, d, s in zip(leaves, self._dtypes, self._shapes)]
        rc = self._lib.ftt_spill_put_cells(
            self._handle(), n, _ptr(gids), _ptr(panes), _ptr(flags),
            _ptr(counts), self._nl, self._leaf_ptrs(cols),
            _ptr(self._leaf_bytes))
        if rc != 0:
            raise OSError(f"spill store: log write failed in "
                          f"{self.directory}")

    def get_many(self, gids, panes, delete: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                            List[np.ndarray]]:
        """(found bool[n], flags uint8[n], counts int64[n], one ``[n,
        *leaf]`` array per leaf) of cells ``(gids[i], panes[i])``; cells not
        found read as zeros.  With ``delete`` the cells found are removed."""
        gids = np.ascontiguousarray(gids, np.int64)
        n = gids.size
        panes = np.ascontiguousarray(np.broadcast_to(panes, (n,)), np.int64)
        found = np.zeros(n, np.uint8)
        flags = np.zeros(n, np.uint8)
        counts = np.zeros(n, np.int64)
        cols = [np.zeros((n,) + s, d)
                for d, s in zip(self._dtypes, self._shapes)]
        rc = self._lib.ftt_spill_get_cells(
            self._handle(), n, _ptr(gids), _ptr(panes), int(bool(delete)),
            _ptr(found), _ptr(flags), _ptr(counts), self._nl,
            self._leaf_ptrs(cols), _ptr(self._leaf_bytes))
        if rc < 0:
            raise OSError(f"spill store: log read or CRC check failed in "
                          f"{self.directory}")
        return found.view(bool), flags, counts, cols

    def delete_many(self, gids, panes) -> int:
        """Delete cells ``(gids[i], panes[i])``; returns how many existed."""
        gids = np.ascontiguousarray(gids, np.int64)
        panes = np.ascontiguousarray(np.broadcast_to(panes, (gids.size,)),
                                     np.int64)
        return int(self._lib.ftt_spill_delete_cells(
            self._handle(), gids.size, _ptr(gids), _ptr(panes)))

    # -- single cells ------------------------------------------------------
    def put(self, gid: int, pane: int, flags: int, count: int,
            leaf_values) -> None:
        self.put_many([gid], [pane], [flags], [count],
                      [np.asarray(v, d).reshape((1,) + s)
                       for v, d, s in zip(leaf_values, self._dtypes,
                                          self._shapes)])

    def get(self, gid: int, pane: int):
        """(flags, count, [leaf values]) or None."""
        found, flags, counts, cols = self.get_many([gid], [pane])
        if not found[0]:
            return None
        return int(flags[0]), int(counts[0]), [c[0] for c in cols]

    def delete(self, gid: int, pane: int) -> bool:
        return self.delete_many([gid], [pane]) > 0

    # -- whole store -------------------------------------------------------
    def clear(self) -> None:
        if not self.closed:
            self._lib.ftt_spill_clear(self._h)

    def __len__(self) -> int:
        return int(self._lib.ftt_spill_count(self._handle()))

    def mem_used(self) -> int:
        # occupancy gauges may read stats after the operator closed: byte
        # gauges report 0 rather than touching a closed handle
        return 0 if self.closed else int(self._lib.ftt_spill_mem_used(self._h))

    def log_bytes(self) -> int:
        return 0 if self.closed else int(self._lib.ftt_spill_log_bytes(self._h))

    def close(self) -> None:
        """Release the C store (and the temporary directory it owns)."""
        self._close()


# ---------------------------------------------------------------------------
# the key-value store
# ---------------------------------------------------------------------------

def _release_kv(lib, handle) -> None:
    lib.ftt_spill_kv_close(handle)


class SpillStore:
    """Memory-budgeted key-value store with a disk log (the RocksDB tier's
    analog; JAX's ``flink_tpu.native.SpillStore``).

    Keys and values are ``bytes``.  Values past ``mem_budget`` resident
    bytes move, oldest write first, to an append-only log in ``directory``;
    :meth:`flush` makes the store durable, so ``SpillStore(directory)``
    reopens it; :meth:`compact` reclaims the log's dead bytes."""

    def __init__(self, directory: str, mem_budget: int = 64 << 20):
        from flink_tpu_torch.kernels.build import spill_store_lib
        self._lib = spill_store_lib()
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._h = self._lib.ftt_spill_kv_open(directory.encode(),
                                              int(mem_budget))
        if not self._h:
            raise RuntimeError(f"spill store: cannot open a log in "
                               f"{directory}")
        self._close = weakref.finalize(self, _release_kv, self._lib, self._h)
        #: the read buffer of :meth:`get`, grown to the largest value read
        self._buf = ctypes.create_string_buffer(4096)

    def _handle(self):
        if not self._close.alive:
            raise ValueError("spill store is closed")
        return self._h

    def put(self, key: bytes, value: bytes) -> None:
        self._lib.ftt_spill_kv_put(self._handle(), key, len(key), value,
                                   len(value))

    def get(self, key: bytes) -> Optional[bytes]:
        """The value of ``key``, or None.  (The read buffer is the store's
        own: one thread reads a store at a time, as one keyed operator
        owns it.)"""
        h = self._handle()
        while True:
            buf = self._buf
            n = self._lib.ftt_spill_kv_get(h, key, len(key), buf, len(buf))
            if n == -1:
                return None
            if n == -2:
                raise OSError(f"spill store: log read or CRC check failed "
                              f"in {self.directory}")
            if n <= len(buf):
                return ctypes.string_at(buf, n)
            self._buf = ctypes.create_string_buffer(int(n))

    def delete(self, key: bytes) -> bool:
        return bool(self._lib.ftt_spill_kv_delete(self._handle(), key,
                                                  len(key)))

    def __len__(self) -> int:
        return int(self._lib.ftt_spill_kv_count(self._handle()))

    def keys(self) -> Iterator[bytes]:
        """The keys present when the walk starts."""
        it = self._lib.ftt_spill_kv_iter_begin(self._handle())
        try:
            cap = 256
            buf = ctypes.create_string_buffer(cap)
            while True:
                n = self._lib.ftt_spill_kv_iter_next(it, buf, cap)
                if n == -1:
                    return
                if n > cap:
                    cap = int(n)
                    buf = ctypes.create_string_buffer(cap)
                    continue
                yield buf.raw[:n]
        finally:
            self._lib.ftt_spill_kv_iter_end(it)

    def mem_used(self) -> int:
        return int(self._lib.ftt_spill_kv_mem_used(self._handle()))

    def log_bytes(self) -> int:
        return int(self._lib.ftt_spill_kv_log_bytes(self._handle()))

    def log_garbage(self) -> int:
        """Dead value bytes in the log (what :meth:`compact` reclaims)."""
        return int(self._lib.ftt_spill_kv_log_garbage(self._handle()))

    def flush(self) -> None:
        if self._lib.ftt_spill_kv_flush(self._handle()) != 0:
            raise OSError(f"spill store: flush failed in {self.directory}")

    def compact(self) -> int:
        """Rewrite the log with only the live spilled values; returns the
        bytes reclaimed."""
        r = int(self._lib.ftt_spill_kv_compact(self._handle()))
        if r < 0:
            raise OSError(f"spill store: compaction failed in "
                          f"{self.directory}")
        return r

    def close(self) -> None:
        self._close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# the spill keyed-state backend
# ---------------------------------------------------------------------------

def _now_ms() -> int:
    """TTL's default clock: the clock seam's wall clock in ms, read at each
    call (a chaos skew schedule steers expiry)."""
    return _clock_seam.now_ms()


class _SpillStateBase:
    kind = "value"

    def __init__(self, backend: "SpillKeyedStateBackend",
                 desc: StateDescriptor):
        self.backend = backend
        self.desc = desc
        self._prefix = desc.name.encode() + b"\x00"

    @property
    def name(self) -> str:
        return self.desc.name

    def _key(self, slot: int) -> bytes:
        return self._prefix + struct.pack("<I", slot)

    def _load(self, slot: int):
        raw = self.backend.store.get(self._key(slot))
        if raw is None:
            return None
        ts, value = pickle.loads(raw)
        ttl = self.desc.ttl
        if ttl is not None and self.backend._clock() - ts >= ttl.ttl_ms:
            return None
        return value

    def _save(self, slot: int, value) -> None:
        self.backend.store.put(self._key(slot),
                               pickle.dumps((self.backend._clock(), value)))

    def _drop(self, slot: int) -> None:
        self.backend.store.delete(self._key(slot))

    def _slot(self) -> int:
        s = self.backend.current_slot()
        if s == _ABSENT:
            raise RuntimeError("no current key set on spill backend")
        return s

    def clear(self) -> None:
        self._drop(self._slot())

    def clear_rows(self, slots: np.ndarray) -> None:
        for s in np.asarray(slots).tolist():
            self._drop(int(s))

    # snapshots: one object-array row field of raw blobs (restore does not
    # depend on the kind: blobs go back into the store under their keys)
    def snapshot(self, n: int) -> Dict[str, Any]:
        rows = np.empty(n, dtype=object)
        for slot in range(n):
            rows[slot] = self.backend.store.get(self._key(slot))
        return {"rows": rows}

    def restore(self, snap: Dict[str, Any]) -> None:
        for slot, blob in enumerate(snap["rows"]):
            if blob is not None:
                self.backend.store.put(self._key(int(slot)), bytes(blob))


class SpillValueState(_SpillStateBase, ValueState):
    kind = "value"

    def value(self):
        return self.value_at(self._slot())

    def update(self, value) -> None:
        self._save(self._slot(), value)

    def value_at(self, slot: int):
        v = self._load(slot)
        return self.desc.default if v is None else v

    def get_rows(self, slots: np.ndarray):
        """The values of ``slots`` as an object array, the default where a
        row is absent (JAX's spill value state's contract)."""
        return np.asarray(
            [self.value_at(int(s)) for s in np.asarray(slots).tolist()],
            dtype=object)

    def put_rows(self, slots: np.ndarray, values) -> None:
        for s, v in zip(np.asarray(slots).tolist(), list(values)):
            self._save(int(s), v)


class SpillListState(_SpillStateBase, ListState):
    kind = "list"

    def get(self) -> list:
        v = self._load(self._slot())
        return [] if v is None else list(v)

    def add(self, value) -> None:
        self.add_rows(np.asarray([self._slot()]), [value])

    def update(self, values) -> None:
        self._save(self._slot(), list(values))

    def add_rows(self, slots: np.ndarray, values) -> None:
        for s, v in zip(np.asarray(slots).tolist(), list(values)):
            cur = self._load(int(s)) or []
            cur.append(v)
            self._save(int(s), cur)

    def get_rows(self, slots: np.ndarray) -> List[list]:
        return [(self._load(int(s)) or []) for s in np.asarray(slots).tolist()]


class SpillMapState(_SpillStateBase, MapState):
    kind = "map"

    def _map(self, slot: int) -> dict:
        return self._load(slot) or {}

    def get(self, key):
        return self._map(self._slot()).get(key)

    def put(self, key, value) -> None:
        self.put_all({key: value})

    def put_all(self, mapping) -> None:
        slot = self._slot()
        m = self._map(slot)
        m.update(mapping)
        self._save(slot, m)

    def remove(self, key) -> None:
        slot = self._slot()
        m = self._map(slot)
        if key in m:
            del m[key]
            self._save(slot, m)

    def contains(self, key) -> bool:
        return key in self._map(self._slot())

    def items(self):
        return list(self._map(self._slot()).items())

    def keys(self):
        return list(self._map(self._slot()).keys())

    def values(self):
        return list(self._map(self._slot()).values())

    def is_empty(self) -> bool:
        return not self._map(self._slot())


class SpillAggregatingState(_SpillStateBase, AggregatingState):
    """An accumulator tree of numpy values pickled per slot; the same
    ``AggregateFunction`` contract as the heap backend (identity, lift,
    combine, get_result)."""

    kind = "aggregating"

    def __init__(self, backend, desc):
        _SpillStateBase.__init__(self, backend, desc)
        self.agg = getattr(desc, "agg", None) or getattr(desc, "reduce_fn")
        self._spec = self.agg.acc_spec()

    def add_rows(self, slots: np.ndarray, values) -> None:
        """Fold row ``i`` of ``values`` into slot ``slots[i]``, in row
        order.  Each key's accumulator is read once, its rows folded in
        order and the result written once, in the order of the keys' first
        rows (JAX's reads and writes once a row: the same values, fewer log
        writes).  Lifted rows take the accumulator's dtypes, as the heap
        backend's fold does (JAX's combine with x64 off keeps the 32-bit
        accumulator); declared add/min/max kinds fold with the heap's numpy
        ufuncs in row order, others through ``combine`` row by row."""
        slots = np.asarray(slots, np.int64)
        if not slots.size:
            return
        spec = self._spec
        lifted = [np.asarray(l).astype(d, copy=False) for l, d in zip(
            tree_leaves(to_numpy(self.agg.lift(to_tensors(values)))),
            spec.leaf_dtypes)]
        uniq, first, inv = np.unique(slots, return_index=True,
                                     return_inverse=True)
        accs = []
        for s in uniq.tolist():
            acc = self._load(s)
            accs.append(spec.leaf_inits if acc is None
                        else tuple(tree_leaves(acc)))
        leaves = [np.stack([np.asarray(a[j], spec.leaf_dtypes[j])
                            for a in accs])
                  for j in range(len(spec.leaf_dtypes))]
        kinds = self.agg.scatter_kind_leaves()
        if kinds is not None:
            for leaf, l, kind in zip(leaves, lifted, kinds):
                SCATTER_UFUNCS[kind].at(leaf, inv, l)
        else:
            for i, u in enumerate(inv.tolist()):
                out = combine_rows(self.agg, tuple(l[u] for l in leaves),
                                   tuple(l[i] for l in lifted))
                for leaf, o in zip(leaves, out):
                    leaf[u] = o
        for u in np.argsort(first, kind="stable").tolist():
            self._save(int(uniq[u]), spec.unflatten(
                [np.array(l[u]) for l in leaves]))

    def get_rows(self, slots: np.ndarray):
        """(results, alive): the heap backend's contract, the results one
        ``get_result`` over every row (absent rows from the identity)."""
        slots = np.asarray(slots)
        spec = self._spec
        accs = [self._load(int(s)) for s in slots.tolist()]
        alive = np.asarray([a is not None for a in accs], bool)
        leaves = [np.stack([np.asarray(init if a is None
                                       else tree_leaves(a)[j], d)
                            for a in accs]) if accs
                  else np.zeros((0,) + sh, d)
                  for j, (init, d, sh) in enumerate(zip(
                      spec.leaf_inits, spec.leaf_dtypes, spec.leaf_shapes))]
        res = host_result(self.agg, spec, leaves)
        if isinstance(res, dict):
            return {k: np.asarray(v) for k, v in res.items()}, alive
        return np.asarray(res), alive

    def _result(self, acc):
        return np.asarray(to_numpy(self.agg.get_result(to_tensors(acc))))[()]

    def get(self):
        acc = self._load(self._slot())
        return None if acc is None else self._result(acc)

    def add(self, value) -> None:
        self.add_rows(np.array([self._slot()]), np.asarray([value]))


class SpillReducingState(SpillAggregatingState, ReducingState):
    """A ReducingState is an AggregatingState whose ACC is the value type."""

    kind = "reducing"


class SpillKeyedStateBackend:
    """Keyed state backend over the C spill store (the RocksDB tier's
    analog): the heap backend's surface where state outgrows memory.  The
    key index (slot ids) stays in memory; values spill.  ``directory``
    holds the log (a fresh temporary directory when None, removed again by
    :meth:`close`); ``clock`` is TTL's clock (None: the clock seam, read at
    each call)."""

    def __init__(self, directory: Optional[str] = None,
                 max_parallelism: int = 128, mem_budget: int = 64 << 20,
                 clock: Optional[Callable[[], int]] = None):
        self.max_parallelism = max_parallelism
        self._owned_dir = None if directory else tempfile.mkdtemp(
            prefix="flink_tpu_torch_spill_")
        self.directory = directory or self._owned_dir
        self.mem_budget = mem_budget
        #: the slot's managed-memory claim (runtime/memory.py), once bound
        self._reservation = None
        self.store = SpillStore(self.directory, mem_budget)
        self._clock = clock if clock is not None else (lambda: _now_ms())
        self._index = None
        self._states: Dict[str, _SpillStateBase] = {}
        self._pending_restore: Dict[str, Dict[str, Any]] = {}
        self._current_slot = _ABSENT

    # -- keys (the heap backend's contract) --------------------------------
    @property
    def num_keys(self) -> int:
        return 0 if self._index is None else self._index.num_keys

    def _ensure_index(self, sample_key):
        if self._index is None:
            self._index = make_key_index(sample_key)
        return self._index

    def key_slots(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys)
        if keys.size == 0:
            return np.zeros(0, np.int32)
        return self._ensure_index(keys[0]).lookup_or_insert(keys)

    def set_current_key(self, key) -> None:
        self._current_slot = int(self.key_slots(np.asarray([key]))[0])

    def current_slot(self) -> int:
        return self._current_slot

    def slot_keys(self, slots: np.ndarray) -> np.ndarray:
        rev = self._index.reverse_keys()
        return np.asarray(rev)[np.asarray(slots)]

    # -- states ------------------------------------------------------------
    def get_state(self, desc: StateDescriptor):
        st = self._states.get(desc.name)
        if st is not None:
            return st
        if isinstance(desc, AggregatingStateDescriptor):
            st = SpillAggregatingState(self, desc)
        elif isinstance(desc, ReducingStateDescriptor):
            st = SpillReducingState(self, desc)
        elif isinstance(desc, state_api.ListStateDescriptor):
            st = SpillListState(self, desc)
        elif isinstance(desc, state_api.MapStateDescriptor):
            st = SpillMapState(self, desc)
        else:
            st = SpillValueState(self, desc)
        self._states[desc.name] = st
        pending = self._pending_restore.pop(desc.name, None)
        if pending is not None:
            st.restore(pending)
        return st

    def value_state(self, name: str, **kw) -> SpillValueState:
        return self.get_state(state_api.ValueStateDescriptor(name, **kw))

    def list_state(self, name: str, **kw) -> SpillListState:
        return self.get_state(state_api.ListStateDescriptor(name, **kw))

    def map_state(self, name: str, **kw) -> SpillMapState:
        return self.get_state(state_api.MapStateDescriptor(name, **kw))

    def reducing_state(self, name: str, reduce_fn, **kw) -> SpillReducingState:
        return self.get_state(state_api.ReducingStateDescriptor(
            name, reduce_fn, **kw))

    def aggregating_state(self, name: str, agg,
                          **kw) -> SpillAggregatingState:
        return self.get_state(state_api.AggregatingStateDescriptor(
            name, agg, **kw))

    # -- snapshot / restore (the repo-standard keyed snapshot) -------------
    def snapshot(self) -> Dict[str, Any]:
        if self._index is None:
            return {"empty": True}
        n = self.num_keys
        snap: Dict[str, Any] = {
            "key_index": self._index.snapshot(),
            "key_index_kind": key_index_kind(self._index),
            "num_keys": n,
            "backend": "spill",
            "state_names": sorted(set(self._states)
                                  | set(self._pending_restore)),
        }
        for name, st in self._states.items():
            for f, v in st.snapshot(n).items():
                snap[f"state.{name}.{f}"] = v
        for name, sub in self._pending_restore.items():
            for f, v in sub.items():
                snap[f"state.{name}.{f}"] = v
        return snap

    @staticmethod
    def row_fields(snap: Dict[str, Any]) -> List[str]:
        return [k for k in snap if k.startswith("state.")]

    def restore(self, snap: Dict[str, Any]) -> None:
        if snap.get("empty"):
            return
        self._index = restore_key_index(
            snap["key_index"], snap.get("key_index_kind", "KeyIndex"))
        for name in snap.get("state_names", []):
            key = f"state.{name}.rows"
            if key not in snap:
                continue
            sub = {"rows": snap[key]}
            st = self._states.get(name)
            if st is None:
                # the blobs go back now; the real descriptor binds through
                # get_state under the same name
                _SpillStateBase(self, state_api.StateDescriptor(name)
                                ).restore(sub)
            else:
                st.restore(sub)

    # -- durability --------------------------------------------------------
    def persist(self) -> None:
        """fsync the spill log and write its manifest (local recovery)."""
        self.store.flush()

    def compact(self) -> int:
        return self.store.compact()

    def reserve_managed(self, manager, owner: str) -> None:
        """Claim this backend's resident-byte budget from the slot's managed
        memory before the job runs, so an over-committed slot fails at open
        time, not as an out-of-memory error mid-job.  Idempotent; released
        by :meth:`close`."""
        if self._reservation is None and manager is not None:
            self._reservation = manager.reserve(owner, self.mem_budget)

    def close(self) -> None:
        if self._reservation is not None:
            self._reservation.release()
            self._reservation = None
        self.store.close()
        if self._owned_dir is not None:
            shutil.rmtree(self._owned_dir, ignore_errors=True)

"""Key -> dense-slot index (numpy port of ``flink_tpu/state/keyindex.py``).

A vectorized open-addressing table for int64 keys: slot ids are dense
(0..n-1, growing), stable for the life of the operator, and double as row
indices into the device state.  :class:`KeyIndex` is the numpy table;
:class:`NativeKeyIndex` is the same surface over the port's C keydict
(``csrc/host_mirror.cc``), whose handle the native window mirror shares.
Both number new keys in order of first occurrence, so they assign equal slot
ids, and both snapshot to ``{"reverse": int64[n]}``.  :func:`make_key_index`
picks the operators' index from a sample key, as JAX's does: the C keydict
for integer keys (JAX's ``KeyIndex`` binds its own C keydict when its native
library loads), and :class:`ObjectKeyIndex` for any other key (strings,
bytes, tuples), numbered in first-seen order by :func:`factorize`, numpy's
counterpart of the ``pd.factorize`` JAX's index is built on.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — avalanching hash for table probing."""
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x


def unique_first(a: np.ndarray, return_inverse: bool = False):
    """``np.unique(a, return_index=True[, return_inverse=True])`` with an
    unstable sort: a value's first index is the least index in its run of
    the sort.  np.unique's ``return_index`` takes a stable sort instead,
    which costs ~3x more on unordered input (new keys arrive in row order,
    i.e. in hash order, everywhere this is called)."""
    perm = a.argsort()
    sa = a[perm]
    head = np.empty(a.size, bool)
    head[:1] = True
    np.not_equal(sa[1:], sa[:-1], out=head[1:])
    starts = np.flatnonzero(head)
    out = (sa[starts], np.minimum.reduceat(perm, starts))
    if return_inverse:
        inv = np.empty(a.size, np.intp)
        inv[perm] = np.cumsum(head) - 1
        out += (inv,)
    return out


class KeyIndex:
    """Vectorized int64-key -> dense int32 slot table (open addressing)."""

    def __init__(self, initial_capacity: int = 1 << 16, max_load: float = 0.5):
        self._max_load = max_load
        self._n = 0
        cap = 1
        while cap < initial_capacity:
            cap <<= 1
        self._cap = cap
        self._mask = np.uint64(cap - 1)
        self._keys = np.zeros(cap, np.int64)
        self._used = np.zeros(cap, bool)
        self._slots = np.zeros(cap, np.int32)
        self._reverse = np.zeros(initial_capacity, np.int64)  # slot -> key

    @property
    def num_keys(self) -> int:
        return self._n

    def reverse_keys(self) -> np.ndarray:
        """slot id -> raw key, length num_keys."""
        return self._reverse[: self._n]

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Batch lookup; returns int32 slot ids, -1 for absent keys."""
        keys = np.ascontiguousarray(keys, np.int64)
        out = np.full(keys.shape, -1, np.int32)
        if keys.size == 0 or self._n == 0:
            return out
        pidx = (_mix64(keys.view(np.uint64)) & self._mask).astype(np.int64)
        pending = np.arange(keys.size, dtype=np.int64)
        while pending.size:
            occupied = self._used[pidx]
            hit = occupied & (self._keys[pidx] == keys[pending])
            out[pending[hit]] = self._slots[pidx[hit]]
            cont = occupied & ~hit
            pending = pending[cont]
            pidx = (pidx[cont] + 1) & np.int64(self._mask)
        return out

    def lookup_or_insert(self, keys: np.ndarray) -> np.ndarray:
        """Batch lookup, inserting unseen keys with fresh sequential slot ids
        in order of first occurrence (the order of the JAX package's C
        keydict).  So one call over concatenated batches assigns the slots
        that one call per batch would, which the fused super-batch lane
        relies on."""
        keys = np.ascontiguousarray(keys, np.int64)
        if keys.size == 0:
            return np.zeros(0, np.int32)
        uniq, first, inv = unique_first(keys, return_inverse=True)
        return self._lookup_or_insert_unique(uniq, first)[inv]

    def _lookup_or_insert_unique(self, uniq: np.ndarray,
                                 first: np.ndarray) -> np.ndarray:
        """Slots of sorted distinct keys; unseen keys are placed in probe
        rounds, then numbered by ``first`` (their first row in the batch)."""
        if self._n + uniq.size > int(self._cap * self._max_load):
            # only truly-new keys consume slots: probe first
            n_new = int(np.count_nonzero(self.lookup(uniq) < 0))
            if self._n + n_new > int(self._cap * self._max_load):
                self._grow(max(self._cap * 2,
                               int((self._n + n_new) / self._max_load) + 1))
        out = np.full(uniq.shape, -1, np.int32)
        fresh = np.zeros(uniq.shape, bool)
        bucket = np.empty(uniq.shape, np.int64)
        pidx = (_mix64(uniq.view(np.uint64)) & self._mask).astype(np.int64)
        pending = np.arange(uniq.size, dtype=np.int64)
        while pending.size:
            occupied = self._used[pidx]
            hit = occupied & (self._keys[pidx] == uniq[pending])
            out[pending[hit]] = self._slots[pidx[hit]]
            # empties: distinct keys racing for one bucket — the first
            # claimant wins, losers re-probe
            empty = ~occupied
            e_pend = pending[empty]
            e_idx = pidx[empty]
            if e_pend.size:
                win_idx, win = unique_first(e_idx)
                w_pend = e_pend[win]
                self._used[win_idx] = True
                self._keys[win_idx] = uniq[w_pend]
                fresh[w_pend] = True
                bucket[w_pend] = win_idx
                out[w_pend] = 0          # placed; numbered below
            unresolved = (out[pending] < 0)
            pending = pending[unresolved]
            pidx = (pidx[unresolved] + 1) & np.int64(self._mask)
        new = np.flatnonzero(fresh)
        if new.size:
            # order by first row, distinct per key: a scatter, not a sort
            by_row = np.full(int(first[new].max()) + 1, -1, np.int64)
            by_row[first[new]] = new
            new = by_row[by_row >= 0]
            slots = self._n + np.arange(new.size, dtype=np.int32)
            self._slots[bucket[new]] = slots
            out[new] = slots
            self._ensure_reverse(self._n + new.size)
            self._reverse[self._n:self._n + new.size] = uniq[new]
            self._n += int(new.size)
        return out

    def _ensure_reverse(self, n: int) -> None:
        if n > self._reverse.size:
            new = np.zeros(max(n, self._reverse.size * 2), np.int64)
            new[: self._n] = self._reverse[: self._n]
            self._reverse = new

    def _grow(self, min_cap: int) -> None:
        cap = self._cap
        while cap < min_cap:
            cap <<= 1
        old_rev = self._reverse[: self._n].copy()
        self._cap = cap
        self._mask = np.uint64(cap - 1)
        self._keys = np.zeros(cap, np.int64)
        self._used = np.zeros(cap, bool)
        self._slots = np.zeros(cap, np.int32)
        self._place_with_ids(old_rev)

    def _place_with_ids(self, keys_in_slot_order: np.ndarray) -> None:
        """Insert unique keys whose slot id == their position (rehash on
        grow, snapshot restore)."""
        n = keys_in_slot_order.size
        if not n:
            return
        pidx = (_mix64(keys_in_slot_order.view(np.uint64))
                & self._mask).astype(np.int64)
        pending = np.arange(n, dtype=np.int64)
        while pending.size:
            empty = ~self._used[pidx]
            e_pend = pending[empty]
            e_idx = pidx[empty]
            placed = np.zeros(pending.size, bool)
            if e_pend.size:
                win_idx, first = np.unique(e_idx, return_index=True)
                w_pend = e_pend[first]
                self._used[win_idx] = True
                self._keys[win_idx] = keys_in_slot_order[w_pend]
                self._slots[win_idx] = w_pend.astype(np.int32)
                placed_mask = np.zeros(n, bool)
                placed_mask[w_pend] = True
                placed = placed_mask[pending]
            pending = pending[~placed]
            pidx = (pidx[~placed] + 1) & np.int64(self._mask)

    def snapshot(self) -> Dict[str, np.ndarray]:
        return {"reverse": self.reverse_keys().copy()}

    @classmethod
    def restore(cls, snap: Dict[str, np.ndarray],
                max_load: float = 0.5) -> "KeyIndex":
        rev = np.asarray(snap["reverse"], np.int64)
        ki = cls(initial_capacity=max(1 << 16, int(rev.size / max_load) + 1),
                 max_load=max_load)
        ki._place_with_ids(rev)
        ki._ensure_reverse(rev.size)
        ki._reverse[: rev.size] = rev
        ki._n = int(rev.size)
        return ki


class NativeKeyIndex(KeyIndex):
    """A :class:`KeyIndex` over the C keydict (as JAX's ``KeyIndex`` is):
    every method is the keydict's, so none of the numpy table's state is
    made.  One C call maps a batch of keys (``lookup``/
    ``lookup_or_insert``), and
    :class:`~flink_tpu_torch.state.native_mirror.NativeWindowMirror`
    inserts through the same :attr:`handle`.  The load factor is the
    keydict's own (0.5).  ``reverse_keys`` keeps a host copy of the slot ->
    key table and appends only the keys inserted since its last call, so
    calling it per batch (``DeviceKeyIndex.ensure_loaded`` does) copies
    each key out of C once.  Raises if the host layer does not build."""

    def __init__(self, initial_capacity: int = 1 << 16):
        from flink_tpu_torch.kernels.build import host_mirror_lib
        self._lib = host_mirror_lib()
        self._handle = self._lib.ftt_keydict_create(int(initial_capacity))
        self._reverse = np.zeros(0, np.int64)   # host copy, [0, _copied)
        self._copied = 0

    def __del__(self):
        h = getattr(self, "_handle", None)
        if h:
            try:
                self._lib.ftt_keydict_destroy(h)
            except Exception:  # noqa: BLE001 — interpreter teardown
                pass
            self._handle = None

    @property
    def handle(self) -> int:
        """The keydict handle the native window mirror shares."""
        return self._handle

    @property
    def num_keys(self) -> int:
        return int(self._lib.ftt_keydict_size(self._handle))

    def reverse_keys(self) -> np.ndarray:
        """slot id -> raw key, length num_keys (a view of the host copy)."""
        n = self.num_keys
        if n > self._copied:
            if n > self._reverse.size:
                grown = np.empty(max(n, 2 * self._reverse.size), np.int64)
                grown[:self._copied] = self._reverse[:self._copied]
                self._reverse = grown
            tail = self._reverse[self._copied:n]
            self._lib.ftt_keydict_reverse_range(
                self._handle, self._copied, n,
                tail.ctypes.data_as(ctypes.c_void_p))
            self._copied = n
        return self._reverse[:n]

    def _call(self, fn, keys: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, np.int64)
        out = np.empty(keys.size, np.int32)
        if keys.size:
            fn(self._handle, keys.ctypes.data, keys.size, out.ctypes.data)
        return out.reshape(keys.shape)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Batch lookup; returns int32 slot ids, -1 for absent keys."""
        return self._call(self._lib.ftt_keydict_lookup, keys)

    def lookup_or_insert(self, keys: np.ndarray) -> np.ndarray:
        """Batch lookup, inserting unseen keys with fresh sequential slot ids
        in order of first occurrence."""
        return self._call(self._lib.ftt_keydict_lookup_or_insert, keys)

    def snapshot(self) -> Dict[str, np.ndarray]:
        return {"reverse": self.reverse_keys().copy()}

    @classmethod
    def restore(cls, snap: Dict[str, np.ndarray]) -> "NativeKeyIndex":
        """Inserting the unique keys in slot order reproduces the slot ids."""
        rev = np.asarray(snap["reverse"], np.int64)
        ki = cls(initial_capacity=max(1 << 16, 2 * rev.size + 1))
        ki.lookup_or_insert(rev)
        return ki


def _code_units(fixed: np.ndarray) -> np.ndarray:
    """A ``U``/``S`` column as its ``[n, width]`` matrix of code units (the
    padding is zeros, so two strings are equal iff their rows are)."""
    unit = np.uint32 if fixed.dtype.kind == "U" else np.uint8
    width = fixed.dtype.itemsize // np.dtype(unit).itemsize
    return np.ascontiguousarray(fixed).view(unit).reshape(fixed.size, width)


def _factorize_fixed(fixed: np.ndarray):
    """``(first, inv)`` of a 1-D ``U``/``S`` column: ``first[j]`` the first
    row of distinct value ``j`` (values in any order), ``inv`` each row's
    value.  A 64-bit hash of the code units groups the rows (one sort of
    int64); the rows are then checked against their group's first row, and
    a collision falls back to numpy's sort of the strings."""
    if fixed.dtype.itemsize == 0:        # every value is the empty string
        return np.zeros(1, np.intp), np.zeros(fixed.size, np.intp)
    units = _code_units(fixed)
    h = np.zeros(fixed.size, np.uint64)
    with np.errstate(over="ignore"):
        for j in range(units.shape[1]):
            h ^= units[:, j]
            h *= np.uint64(0x100000001B3)
    _, first, inv = unique_first(_mix64(h).view(np.int64),
                                 return_inverse=True)
    if not (units == units[first[inv]]).all():
        _, first, inv = np.unique(fixed, return_index=True,
                                  return_inverse=True)
    return first, inv.reshape(-1)


def _is_null(k) -> bool:
    """A null key as ``pd.factorize`` sees one: None or a float NaN."""
    return k is None or (isinstance(k, (float, np.floating)) and k != k)


def factorize(keys) -> tuple:
    """``(codes, uniques)`` of a key column, as ``pd.factorize`` gives them
    (numpy only): ``uniques`` an object array in order of first occurrence,
    ``codes`` int64 per row, -1 for a null key (None, NaN).  String and
    bytes columns (``U``/``S`` arrays, or object arrays of ``str`` or of
    ``bytes`` alone) group their rows in bulk; tuples and mixed objects,
    which do not sort, go row by row through a dict (equal keys by Python's
    ``==``, so ``1``, ``1.0`` and ``True`` are one key, as in pandas)."""
    arr = np.asarray(keys)
    if arr.ndim != 1:                    # composite keys: one tuple a row
        col = np.empty(len(arr), object)
        col[:] = [tuple(r) for r in arr.tolist()]
        arr = col
    if arr.size == 0:
        return np.zeros(0, np.int64), np.empty(0, object)
    if arr.dtype.kind == "O" and arr.size:
        items = arr.tolist()
        kinds = set(map(type, items))
        # numpy drops trailing NULs of U/S cells: such keys stay objects
        if kinds <= {str, np.str_} and "\0" not in "".join(items):
            arr = arr.astype("U")
        elif kinds <= {bytes, np.bytes_} and b"\0" not in b"".join(items):
            arr = arr.astype("S")
    if arr.dtype.kind in "US":
        first, inv = _factorize_fixed(arr)
        order = np.argsort(first)
        rank = np.empty(order.size, np.int64)
        rank[order] = np.arange(order.size)
        uniques = np.empty(order.size, object)
        uniques[:] = arr[first[order]].tolist()
        return rank[inv], uniques
    seen: Dict[object, int] = {}
    codes = np.empty(arr.size, np.int64)
    for i, k in enumerate(arr.tolist() if arr.dtype.kind != "O" else arr):
        if _is_null(k):
            codes[i] = -1
            continue
        c = seen.get(k)
        if c is None:
            c = seen[k] = len(seen)
        codes[i] = c
    uniques = np.empty(len(seen), object)
    uniques[:] = list(seen)
    return codes, uniques


class ObjectKeyIndex:
    """Object (string, bytes, tuple, mixed) key -> dense int32 slot, numbered
    in order of first occurrence (port of JAX's ``ObjectKeyIndex``, which
    numbers through ``pd.factorize``; :func:`factorize` is its numpy
    counterpart).  The dict is touched once per distinct key of a batch.
    Null keys (None, NaN) raise ``ValueError`` on insert, as in JAX; the
    snapshot is ``{"reverse": object[n]}``, the same as JAX's."""

    def __init__(self):
        self._dict: Dict[object, int] = {}
        self._reverse = np.empty(0, object)
        self._n = 0

    @property
    def num_keys(self) -> int:
        return self._n

    def reverse_keys(self) -> np.ndarray:
        """slot id -> raw key, length num_keys (an object array)."""
        return self._reverse[:self._n]

    def _append(self, new: list) -> None:
        need = self._n + len(new)
        if need > self._reverse.size:
            grown = np.empty(max(need, 2 * self._reverse.size), object)
            grown[:self._n] = self._reverse[:self._n]
            self._reverse = grown
        self._reverse[self._n:need] = new
        self._n = need

    def lookup_or_insert(self, keys: np.ndarray) -> np.ndarray:
        codes, uniques = factorize(keys)
        if (codes < 0).any():
            raise ValueError("null/NaN keys are not allowed in keyed streams")
        ids = np.empty(uniques.size, np.int32)
        d = self._dict
        new = []
        for i, k in enumerate(uniques):
            sid = d.get(k)
            if sid is None:
                sid = d[k] = self._n + len(new)
                new.append(k)
            ids[i] = sid
        if new:
            self._append(new)
        return ids[codes]

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Batch lookup; int32 slot ids, -1 for absent or null keys."""
        codes, uniques = factorize(keys)
        ids = np.fromiter((self._dict.get(k, -1) for k in uniques), np.int32,
                          uniques.size)
        out = np.full(codes.shape, -1, np.int32)
        hit = codes >= 0
        out[hit] = ids[codes[hit]]
        return out

    def snapshot(self) -> Dict[str, np.ndarray]:
        return {"reverse": self.reverse_keys().copy()}

    @classmethod
    def restore(cls, snap) -> "ObjectKeyIndex":
        ki = cls()
        rev = list(snap["reverse"])
        ki._dict = {k: i for i, k in enumerate(rev)}
        ki._append(rev)
        return ki


def key_index_kind(index) -> str:
    """The ``key_index_kind`` a snapshot of ``index`` carries, in JAX's
    spelling: ``"ObjectKeyIndex"``, or ``"KeyIndex"`` for the integer
    tables (numpy or C: they snapshot alike)."""
    return ("ObjectKeyIndex" if isinstance(index, ObjectKeyIndex)
            else "KeyIndex")


def make_key_index(sample_key, capacity_hint: int = 0):
    """The key index of an operator whose keys look like ``sample_key``
    (port of ``flink_tpu/state/keyindex.py`` ``make_key_index``): the C
    keydict for an integer key, pre-sized to twice ``capacity_hint`` (the
    load-factor bound), so a hinted run never rehashes; any other key
    (strings, bytes, tuples, a composite sample that parses as an int
    array) an :class:`ObjectKeyIndex`.  A failing build of the host layer
    raises."""
    arr = np.asarray(sample_key)
    if arr.ndim == 0 and arr.dtype.kind in "iu":
        return NativeKeyIndex(initial_capacity=max(1 << 16,
                                                   2 * capacity_hint))
    return ObjectKeyIndex()


def restore_key_index(snap: Dict[str, np.ndarray], kind: str = "KeyIndex"):
    """The index a snapshot's ``key_index`` (``{"reverse": ...}``) and
    ``key_index_kind`` describe, in JAX's spelling, so either package
    restores the other's snapshots."""
    if kind == "ObjectKeyIndex":
        return ObjectKeyIndex.restore(snap)
    return NativeKeyIndex.restore(snap)

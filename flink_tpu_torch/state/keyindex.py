"""Key -> dense-slot index (numpy port of ``flink_tpu/state/keyindex.py``).

A vectorized open-addressing table for int64 keys: slot ids are dense
(0..n-1, growing), stable for the life of the operator, and double as row
indices into the device state.  The port carries the numpy table only; the C
keydict of the JAX package is not loaded here.
"""

from __future__ import annotations

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
        """Batch lookup, inserting unseen keys with fresh sequential slot ids."""
        keys = np.ascontiguousarray(keys, np.int64)
        if keys.size == 0:
            return np.zeros(0, np.int32)
        uniq, inv = np.unique(keys, return_inverse=True)
        return self._lookup_or_insert_unique(uniq)[inv]

    def _lookup_or_insert_unique(self, uniq: np.ndarray) -> np.ndarray:
        if self._n + uniq.size > int(self._cap * self._max_load):
            # only truly-new keys consume slots: probe first
            n_new = int(np.count_nonzero(self.lookup(uniq) < 0))
            if self._n + n_new > int(self._cap * self._max_load):
                self._grow(max(self._cap * 2,
                               int((self._n + n_new) / self._max_load) + 1))
        out = np.full(uniq.shape, -1, np.int32)
        pidx = (_mix64(uniq.view(np.uint64)) & self._mask).astype(np.int64)
        pending = np.arange(uniq.size, dtype=np.int64)
        while pending.size:
            occupied = self._used[pidx]
            hit = occupied & (self._keys[pidx] == uniq[pending])
            out[pending[hit]] = self._slots[pidx[hit]]
            # empties: distinct keys racing for one bucket — np.unique picks
            # the first as winner, losers re-probe
            empty = ~occupied
            e_pend = pending[empty]
            e_idx = pidx[empty]
            if e_pend.size:
                win_idx, first = np.unique(e_idx, return_index=True)
                w_pend = e_pend[first]
                new_slots = self._n + np.arange(w_pend.size, dtype=np.int32)
                self._used[win_idx] = True
                self._keys[win_idx] = uniq[w_pend]
                self._slots[win_idx] = new_slots
                self._ensure_reverse(self._n + w_pend.size)
                self._reverse[self._n: self._n + w_pend.size] = uniq[w_pend]
                self._n += int(w_pend.size)
                out[w_pend] = new_slots
            unresolved = out[pending] < 0
            pending = pending[unresolved]
            pidx = (pidx[unresolved] + 1) & np.int64(self._mask)
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

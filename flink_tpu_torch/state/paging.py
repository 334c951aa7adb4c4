"""Cold-key paging: the device pane ring as a cache over an unbounded key
space (port of ``flink_tpu/state/paging.py``).

The ``[K_cap, P, *leaf]`` ring of the device emit tier of
:class:`~flink_tpu_torch.operators.window_agg.WindowAggOperator` holds only
the HOT keys; cold keys' pane cells live serialized in a memory-budgeted
:class:`~flink_tpu_torch.state.spill.PaneSpillStore`, which itself overflows
to a log on disk.  Key cardinality is no longer capped by device memory.

Split of labor, as in the JAX package:

- :class:`DevicePager` (here) owns every HOST-side decision: the residency
  map (global key id -> ring row), victim selection (clock second-chance or
  exact LRU), the per-pane spilled-key bitmaps, and the serialized
  (key, pane) entries in the store (count + emit-mirror bit + leaf values in
  device dtypes, so eviction and promotion round-trip bit for bit).
- The operator owns every DEVICE dispatch: one gather of the evicted rows'
  live-pane cells (page-out), one reset + set of the promoted rows
  (page-in), and one pane combine + ``get_result`` over uploaded columns
  when spilled keys take part in a window fire.

The pager makes the JAX pager's decisions (the same calls give the same
victims, the same rows, the same spilled bitmaps and the same counters), but
its store work runs array-at-a-time: a page-out, a promotion, an expiry, a
snapshot fill or a restore import is one call of the store's array entries
per batch, never a Python loop over cells.

Invariant: every (key, pane) cell lives in EXACTLY one tier.  Promotion
folds a key's spilled cells back into its fresh ring row (and deletes the
entries) before the batch's fold touches the row, so a promoted key's
accumulation history is identical to an always-resident key's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.state.spill import PaneSpillStore

#: flags bit: the (key, pane) cell was marked in the host emit mirror
MIRROR_BIT = 1

#: rows examined per clock-sweep chunk (vectorized second-chance scan)
_CLOCK_CHUNK = 4096


def identity_grid(spec, rows: int, cols: int) -> List[np.ndarray]:
    """One ``[rows, cols, *leaf]`` array per ACC leaf, filled with the
    accumulator identity in DEVICE dtypes — the shared cell-grid layout of
    page-in columns, spilled fires and dense snapshots."""
    out = []
    for init, shape, dt in zip(spec.leaf_inits, spec.leaf_shapes,
                               spec.leaf_dtypes):
        arr = np.empty((rows, cols) + tuple(shape), dt)
        arr[...] = np.asarray(init).astype(dt)
        out.append(arr)
    return out


@dataclass
class PagingConfig:
    """Operator-facing paging knobs.

    capacity:   resident key capacity K_cap (rounded up to a power of two
                by the operator) — the device footprint stays ``K_cap * P``
                cells regardless of key cardinality.
    policy:     "clock" (second-chance ref bits, O(1) amortized) or "lru"
                (exact least-recently-touched via access ticks).
    directory:  spill directory for the store's disk log (a fresh temp dir
                when None).
    mem_budget: resident-byte budget of the store before IT evicts entries
                to its disk log.
    """

    capacity: int
    policy: str = "clock"
    directory: Optional[str] = None
    mem_budget: int = 64 << 20


class DevicePager:
    """Host-side residency manager for one operator's pane ring."""

    def __init__(self, config: PagingConfig, spec, capacity: int):
        if config.policy not in ("clock", "lru"):
            raise ValueError(f"paging policy must be clock|lru, "
                             f"got {config.policy!r}")
        if config.capacity <= 0:
            raise ValueError("paging capacity must be positive")
        self.config = config
        self.spec = spec
        self.K = int(capacity)
        self.store = PaneSpillStore(config.directory, config.mem_budget,
                                    spec.leaf_dtypes, spec.leaf_shapes)
        #: lifetime counters (evictions: keys paged out; promotions: keys
        #: whose spilled cells moved back into the ring)
        self.evictions = 0
        self.promotions = 0
        self._reset_maps()

    def _reset_maps(self) -> None:
        #: global key id -> ring row, -1 = not resident (grows with keys)
        self.row_of = np.full(1024, -1, np.int32)
        #: ring row -> global key id, -1 = free
        self.gid_of = np.full(self.K, -1, np.int64)
        self._tick = np.zeros(self.K, np.int64)   # lru: last-touch stamp
        self._ref = np.zeros(self.K, np.uint8)    # clock: second-chance bit
        self._hand = 0
        self._clock = 0
        self._n_resident = 0
        self._next_free = 0                       # fresh rows low-water mark
        #: rows recycled by eviction, a stack: [:_n_free] in push order
        self._free = np.empty(self.K, np.int64)
        self._n_free = 0
        #: pane id -> bool[num_keys] "this key has a spilled cell here"
        self.spilled: Dict[int, np.ndarray] = {}

    def reset(self) -> None:
        """Drop all residency + spilled state (operator ``reset_state``)."""
        self.store.clear()
        self._reset_maps()
        self.evictions = 0
        self.promotions = 0

    def close(self) -> None:
        self.store.close()

    # -- residency map ------------------------------------------------------
    def ensure_gids(self, n: int) -> None:
        if n > self.row_of.size:
            grown = np.full(max(n, self.row_of.size * 2), -1, np.int32)
            grown[: self.row_of.size] = self.row_of
            self.row_of = grown

    def rows(self, gids: np.ndarray) -> np.ndarray:
        return self.row_of[gids]

    @property
    def row_high_water(self) -> int:
        """Rows ever assigned (fresh low-water mark): bounds live rows."""
        return self._next_free

    def free_count(self) -> int:
        return (self.K - self._next_free) + self._n_free

    def touch(self, rows: np.ndarray) -> None:
        self._clock += 1
        self._tick[rows] = self._clock
        self._ref[rows] = 1

    def resident_pairs(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, gids) of every assigned row, ascending row order."""
        rows = np.flatnonzero(self.gid_of >= 0)
        return rows.astype(np.int32), self.gid_of[rows]

    # -- victim selection ---------------------------------------------------
    def pick_victims(self, n: int, protected_rows: np.ndarray) -> np.ndarray:
        """``n`` cold resident rows to evict; never rows of keys in the
        current batch (``protected_rows``) — their cells are about to be
        folded into."""
        elig = self.gid_of >= 0
        if protected_rows.size:
            elig[protected_rows] = False
        if int(np.count_nonzero(elig)) < n:
            raise RuntimeError(
                f"paging: batch working set exceeds capacity (need {n} "
                f"victims, {int(np.count_nonzero(elig))} eligible of "
                f"K_cap={self.K}) — shrink the batch or raise capacity")
        if self.config.policy == "lru":
            cand = np.flatnonzero(elig)
            if n >= cand.size:
                return cand.astype(np.int32)
            pick = cand[np.argpartition(self._tick[cand], n - 1)[:n]]
            return pick.astype(np.int32)
        # clock: vectorized second-chance sweep.  Two full sweeps clear
        # every ref bit, so the bound below always terminates with picks.
        out = np.empty(n, np.int64)
        filled = 0
        chunks_per_sweep = (self.K + _CLOCK_CHUNK - 1) // _CLOCK_CHUNK
        for _ in range(3 * chunks_per_sweep + 1):
            idx = (self._hand + np.arange(min(_CLOCK_CHUNK, self.K))) % self.K
            self._hand = int((self._hand + idx.size) % self.K)
            cand = idx[elig[idx]]
            if cand.size == 0:
                continue
            second = self._ref[cand] == 1
            self._ref[cand[second]] = 0   # second chance spent
            pick = cand[~second]
            take = min(n - filled, pick.size)
            out[filled: filled + take] = pick[:take]
            elig[pick[:take]] = False
            filled += take
            if filled >= n:
                break
        if filled < n:          # pathological interleaving: force-complete
            rest = np.flatnonzero(elig)[: n - filled]
            out[filled: filled + rest.size] = rest
            filled += rest.size
        return out[:n].astype(np.int32)

    # -- page-out / page-in -------------------------------------------------
    def spill_rows(self, victim_rows: np.ndarray, panes: np.ndarray,
                   counts: np.ndarray, leaves: List[np.ndarray],
                   mirror_bits: np.ndarray) -> None:
        """Serialize the victims' live-pane cells (downloaded by the
        operator) into the store and free their rows.  ``counts`` is
        ``[V, m]`` int, ``leaves`` one ``[V, m, *leaf]`` array per ACC leaf,
        ``mirror_bits`` ``[V, m]`` bool.  A cell spills iff its count is
        non-zero or its mirror bit is set; cells go to the store victim by
        victim, pane by pane (the JAX pager's order, which the store's
        eviction to its log follows)."""
        gids = self.gid_of[victim_rows]
        panes = np.asarray(panes, np.int64)
        mirror_bits = np.asarray(mirror_bits, bool)
        keep = (np.asarray(counts) != 0) | mirror_bits
        vi, pj = np.nonzero(keep)                 # row-major: victim, pane
        if vi.size:
            self.store.put_many(
                gids[vi], panes[pj],
                np.where(mirror_bits[vi, pj], MIRROR_BIT, 0),
                np.asarray(counts)[vi, pj], [l[vi, pj] for l in leaves])
            for j, p in enumerate(panes.tolist()):
                self._mark_spilled(p, gids[keep[:, j]])
        self.row_of[gids] = -1
        self.gid_of[victim_rows] = -1
        self._ref[victim_rows] = 0
        self._free_push(np.asarray(victim_rows, np.int64))
        self._n_resident -= int(victim_rows.size)
        self.evictions += int(victim_rows.size)

    def _free_push(self, rows: np.ndarray) -> None:
        self._free[self._n_free: self._n_free + rows.size] = rows
        self._n_free += rows.size

    def assign_rows(self, gids: np.ndarray) -> Tuple[np.ndarray, int]:
        """Bind free rows to ``gids`` (promotion/new keys): fresh rows first,
        then the most recently freed ones; returns (rows int32,
        n_recycled) — recycled rows carry stale device cells the operator
        must reset before use."""
        need = int(gids.size)
        rows = np.empty(need, np.int64)
        fresh = min(need, self.K - self._next_free)
        if fresh:
            rows[:fresh] = np.arange(self._next_free, self._next_free + fresh)
            self._next_free += fresh
        recycled = need - fresh
        if recycled:
            top = self._n_free
            rows[fresh:] = self._free[top - recycled: top][::-1]
            self._n_free -= recycled
        self.row_of[gids] = rows
        self.gid_of[rows] = gids
        self._n_resident += need
        self.touch(rows)
        return rows.astype(np.int32), recycled

    def _spilled_cells(self, gids: np.ndarray, panes: np.ndarray):
        """(i, j) of the cells ``gids[i] x panes[j]`` the bitmaps mark as
        spilled, pane by pane, ``i`` ascending within a pane."""
        ii, jj = [], []
        for j, p in enumerate(np.asarray(panes).tolist()):
            mark = self.spilled.get(int(p))
            if mark is None:
                continue
            inside = gids < mark.size
            sel = np.flatnonzero(inside)
            sel = sel[mark[gids[sel]]]
            ii.append(sel)
            jj.append(np.full(sel.size, j, np.int64))
        if not ii:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(ii), np.concatenate(jj)

    def load_entries(self, gids: np.ndarray, panes: np.ndarray,
                     delete: bool):
        """Dense ``[R, m]`` columns of the spilled cells of ``gids`` over
        ``panes`` (identity where nothing is spilled): (counts int32,
        leaves in device dtypes, mirror bits, found bool[R]).  With
        ``delete`` the entries move OUT of the spill tier (promotion) and
        the promotion counter advances by the keys found."""
        gids = np.asarray(gids, np.int64)
        panes = np.asarray(panes, np.int64)
        R, m = int(gids.size), int(panes.size)
        counts = np.zeros((R, m), np.int32)
        bits = np.zeros((R, m), bool)
        leaves = identity_grid(self.spec, R, m)
        found = np.zeros(R, bool)
        ii, jj = self._spilled_cells(gids, panes)
        if ii.size:
            hit, flags, c, vals = self.store.get_many(gids[ii], panes[jj],
                                                      delete=delete)
            ii, jj, flags, c = ii[hit], jj[hit], flags[hit], c[hit]
            counts[ii, jj] = c
            bits[ii, jj] = ((flags & MIRROR_BIT) != 0) | (c > 0)
            for dst, v in zip(leaves, vals):
                dst[ii, jj] = v[hit]
            found[ii] = True
            if delete:
                for j in np.unique(jj).tolist():
                    self.spilled[int(panes[j])][gids[ii[jj == j]]] = False
        if delete:
            self.promotions += int(found.sum())
        return counts, leaves, bits, found

    # -- spilled-key queries -------------------------------------------------
    def any_spilled(self, gids: np.ndarray, panes: np.ndarray) -> bool:
        """Cheap pre-check: does ANY of ``gids`` hold a spilled cell in any
        of ``panes``?  Saves the dense load_entries grids on the dominant
        all-new-keys batches while the key space is still growing."""
        gids = np.asarray(gids)
        for p in np.asarray(panes).tolist():
            mark = self.spilled.get(int(p))
            if mark is None:
                continue
            sub = gids[gids < mark.size]
            if sub.size and mark[sub].any():
                return True
        return False

    def _mark_spilled(self, pane: int, gids: np.ndarray) -> None:
        if gids.size == 0:
            return
        arr = self.spilled.get(pane)
        top = int(gids.max()) + 1
        if arr is None or arr.size < top:
            grown = np.zeros(max(self.row_of.size, top), bool)
            if arr is not None:
                grown[: arr.size] = arr
            arr = self.spilled[pane] = grown
        arr[gids] = True

    def spilled_gids(self, panes: np.ndarray) -> np.ndarray:
        """Ascending global ids holding a spilled cell in any of ``panes``."""
        acc: Optional[np.ndarray] = None
        for p in np.asarray(panes).tolist():
            mark = self.spilled.get(int(p))
            if mark is None:
                continue
            if acc is None:
                acc = mark.copy()
            else:
                if acc.size < mark.size:
                    acc = np.pad(acc, (0, mark.size - acc.size))
                acc[: mark.size] |= mark
        if acc is None:
            return np.empty(0, np.int64)
        return np.flatnonzero(acc).astype(np.int64)

    def drop_panes(self, panes) -> None:
        """Pane expiry: delete every spilled cell of the expired panes."""
        for p in panes:
            mark = self.spilled.pop(int(p), None)
            if mark is not None:
                self.store.delete_many(np.flatnonzero(mark), int(p))

    # -- snapshot / restore ---------------------------------------------------
    def fill_snapshot(self, counts: np.ndarray, leaves: List[np.ndarray],
                      panes: np.ndarray) -> None:
        """Merge spilled cells into dense gid-indexed snapshot arrays
        (``counts [n, m]``, one ``[n, m, *leaf]`` per leaf) — the
        repo-standard keyed snapshot format."""
        panes = np.asarray(panes, np.int64)
        gl, jl = [], []
        for j, p in enumerate(panes.tolist()):
            mark = self.spilled.get(int(p))
            if mark is None:
                continue
            g = np.flatnonzero(mark)
            gl.append(g)
            jl.append(np.full(g.size, j, np.int64))
        if not gl:
            return
        g, j = np.concatenate(gl), np.concatenate(jl)
        hit, _flags, c, vals = self.store.get_many(g, panes[j])
        g, j = g[hit], j[hit]
        counts[g, j] = c[hit]
        for dst, v in zip(leaves, vals):
            dst[g, j] = v[hit]

    def import_rows(self, gids: np.ndarray, panes: np.ndarray,
                    counts: np.ndarray, leaves: List[np.ndarray]) -> None:
        """Restore overflow: spill snapshot rows (gid-indexed dense arrays)
        that do not fit the resident capacity; every non-empty cell enters
        the store with its mirror bit set."""
        gids = np.asarray(gids, np.int64)
        panes = np.asarray(panes, np.int64)
        sub = np.asarray(counts)[gids]
        gi, pj = np.nonzero(sub)                  # row-major: key, pane
        if gi.size == 0:
            return
        g = gids[gi]
        self.store.put_many(g, panes[pj], MIRROR_BIT, sub[gi, pj],
                            [np.asarray(l)[g, pj] for l in leaves])
        for j, p in enumerate(panes.tolist()):
            self._mark_spilled(p, g[pj == j])

    # -- observability --------------------------------------------------------
    def stats(self, num_keys: int) -> Dict[str, int]:
        """Occupancy + lifetime counters (``paging.*``)."""
        return {
            "resident_keys": int(self._n_resident),
            "spilled_keys": int(max(0, num_keys - self._n_resident)),
            "evictions": int(self.evictions),
            "promotions": int(self.promotions),
            "capacity": int(self.K),
            "spill_mem_bytes": int(self.store.mem_used()),
            "spill_log_bytes": int(self.store.log_bytes()),
        }

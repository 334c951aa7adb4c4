"""Fire-time published live-read views: barrier-free queryable window state.

The live consistency level of the queryable serving tier (port of
``flink_tpu/queryable/view.py``).
Instead of probing the operator's key index from a foreign thread (the old
``server.py`` stub — a read racing the task thread's backend), the operator
PUBLISHES an immutable columnar view of every window it fires: the very
``(keys, values)`` arrays the fire emitted downstream, tagged with the
watermark and last-completed-checkpoint id they reflect.  Those values come
off the host value mirror after the pane-granular device-delta catch-up
(``_fire_window_host`` -> ``_devprobe_sync_mirror`` -> ``wm_apply_delta``),
so a live read is **bit-equal to the operator's own fire-time values** for
already-fired panes — on any tier (host/device/deferred), at any mesh size,
and through a quarantine degrade, because every fire path funnels through
the same publish hook.

Concurrency contract: publishing swaps one tuple reference on the task
thread (queries never see a half-built segment); lookups read that
reference once and then touch only frozen arrays.  No locks, no pipeline
barrier, no operator state reads — the ``paging_stats()`` monitoring
contract, extended to values.  The per-segment sort index is built lazily
on the FIRST query (never on the hot path) and memoized; a benign race
builds it twice with identical results.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class _Segment:
    """One fired window's emissions, frozen: ``keys[i]`` emitted the value
    row ``{col: cols[col][i]}`` when the window fired."""

    __slots__ = ("window_start", "window_end", "keys", "cols", "watermark",
                 "checkpoint_id", "_order", "_sorted_keys", "_key_map")

    def __init__(self, window_start: int, window_end: int, keys: np.ndarray,
                 cols: Dict[str, np.ndarray], watermark: int,
                 checkpoint_id: Optional[int]):
        self.window_start = int(window_start)
        self.window_end = int(window_end)
        self.keys = keys
        self.cols = cols
        self.watermark = int(watermark)
        self.checkpoint_id = checkpoint_id
        self._order = None        # lazy argsort (int keys)
        self._sorted_keys = None
        self._key_map = None      # lazy dict (object keys)

    def locate(self, keys: np.ndarray) -> np.ndarray:
        """Row index per queried key, -1 where absent."""
        out = np.full(len(keys), -1, np.int64)
        if self.keys.size == 0 or len(keys) == 0:
            return out
        if self.keys.dtype.kind in "iu" and \
                np.asarray(keys).dtype.kind in "iu":
            if self._order is None:
                order = np.argsort(self.keys, kind="stable")
                self._sorted_keys = self.keys[order]
                self._order = order       # publish AFTER sorted_keys exists
            q = np.asarray(keys, self.keys.dtype)
            pos = np.searchsorted(self._sorted_keys, q)
            pos = np.minimum(pos, self._sorted_keys.size - 1)
            hit = self._sorted_keys[pos] == q
            out[hit] = self._order[pos[hit]]
            return out
        if self._key_map is None:
            self._key_map = {k: i for i, k in enumerate(self.keys.tolist())}
        kmap = self._key_map
        for i, k in enumerate(np.asarray(keys, object).tolist()):
            out[i] = kmap.get(k, -1)
        return out


class WindowReadView:
    """Per-operator live-read view: a bounded ring of fired-window segments.

    ``publish`` is called by the firing operator on its task thread (cost:
    one tuple rebuild per fired window — fires are orders of magnitude
    rarer than records); ``lookup_batch`` is called by query threads and
    serves each key's value from the NEWEST segment containing it."""

    def __init__(self, key_column: str, retain_windows: int = 4):
        self.key_column = key_column
        self.retain_windows = max(1, int(retain_windows))
        self._segments: Tuple[_Segment, ...] = ()
        self.published_windows = 0

    @property
    def epoch(self) -> int:
        """Monotone content version: bumps on every publish.  The hot-key
        response cache keys its live entries on this (checkpoint-replica
        entries key on the serving checkpoint id)."""
        return self.published_windows

    # ----------------------------------------------------------- task thread
    def publish(self, keys: np.ndarray, cols: Dict[str, Any], window,
                watermark: int, checkpoint_id: Optional[int]) -> None:
        """Retain one fire's emissions (zero-copy: the emitted arrays are
        shared, never mutated after emission)."""
        seg = _Segment(window.start, window.end, np.asarray(keys),
                       {c: np.asarray(v) for c, v in cols.items()},
                       watermark, checkpoint_id)
        segs = (seg,) + self._segments
        # retain the newest few distinct windows (chunked fires — spilled
        # keys, paged tiers — publish several segments for one window)
        starts: List[int] = []
        keep: List[_Segment] = []
        for s in segs:
            if s.window_start not in starts:
                starts.append(s.window_start)
            if len(starts) > self.retain_windows:
                break
            keep.append(s)
        self._segments = tuple(keep)   # atomic swap
        # epoch bumps AFTER the swap: a cached lookup racing publish may
        # memoize the old segments under the old epoch (correct — the
        # next epoch read invalidates it), never old data under the new
        # epoch (which nothing would ever invalidate)
        self.published_windows += 1

    # ---------------------------------------------------------- query threads
    def tags(self) -> Dict[str, Any]:
        segs = self._segments
        if not segs:
            return {"watermark": None, "checkpoint_id": None,
                    "window_start": None, "window_end": None}
        newest = segs[0]
        return {"watermark": newest.watermark,
                "checkpoint_id": newest.checkpoint_id,
                "window_start": newest.window_start,
                "window_end": newest.window_end}

    def lookup_batch(self, keys: np.ndarray
                     ) -> Tuple[np.ndarray, List[Optional[Dict[str, Any]]],
                                Dict[str, Any]]:
        """(found mask, per-key value dict or None, tags).  Each key's value
        comes from the newest segment containing it — the last fired window
        the key contributed to."""
        segs = self._segments
        n = len(keys)
        found = np.zeros(n, bool)
        values: List[Optional[Dict[str, Any]]] = [None] * n
        remaining = np.arange(n)
        for seg in segs:
            if remaining.size == 0:
                break
            idx = seg.locate(np.asarray(keys)[remaining])
            hit = idx >= 0
            if not hit.any():
                continue
            rows = idx[hit]
            for qi, row in zip(remaining[hit].tolist(), rows.tolist()):
                v = {c: plain(a[row]) for c, a in seg.cols.items()}
                v["window_start"] = seg.window_start
                v["window_end"] = seg.window_end
                values[qi] = v
            found[remaining[hit]] = True
            remaining = remaining[~hit]
        return found, values, self.tags()

    def lookup_batch_columnar(self, keys: np.ndarray
                              ) -> Tuple[np.ndarray, Dict[str, np.ndarray],
                                         Dict[str, Any]]:
        """The binary-wire fast path: (found mask, dense result columns,
        tags) with ZERO per-key Python objects — each segment's hits are
        gathered with one fancy-index per column.  Unfound rows are
        zero filler (the wire ships the found plane alongside).  Window
        bounds ride as two extra int64 columns so the answer carries the
        same information as the dict path's per-key values."""
        segs = self._segments
        keys = np.asarray(keys)
        n = len(keys)
        found = np.zeros(n, bool)
        cols: Dict[str, np.ndarray] = {}
        remaining = np.arange(n)
        for seg in segs:
            if remaining.size == 0:
                break
            idx = seg.locate(keys[remaining])
            hit = idx >= 0
            if not hit.any():
                continue
            qsel = remaining[hit]
            rows = idx[hit]
            if not cols:
                for c, a in seg.cols.items():
                    cols[c] = (np.empty(n, object) if a.dtype.kind == "O"
                               else np.zeros(n, a.dtype))
                cols["window_start"] = np.zeros(n, np.int64)
                cols["window_end"] = np.zeros(n, np.int64)
            for c, a in seg.cols.items():
                out = cols.get(c)
                if out is None:
                    continue
                got = a[rows]
                out[qsel] = got if out.dtype == a.dtype \
                    else got.astype(out.dtype)
            cols["window_start"][qsel] = seg.window_start
            cols["window_end"][qsel] = seg.window_end
            found[qsel] = True
            remaining = remaining[~hit]
        return found, cols, self.tags()


def plain(v):
    """numpy scalar/array -> JSON-serializable python value (the one
    wire-coercion rule of the queryable package — view, replica, and
    legacy backend answers all go through here)."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def is_scalar_key(k) -> bool:
    """The protocol's key contract: JSON scalars only (str/int/float/
    bool) — lists/dicts/null would crash hashing/routing deep in a
    handler thread instead of returning a clean error."""
    return isinstance(k, (str, int, float, bool))


def coerce_keys(keys) -> np.ndarray:
    """Wire-format (JSON) keys -> the lookup key array: all-int batches
    become int64 (the dense key-index dtype), anything else stays object
    (string/mixed keys route through the object key path)."""
    if isinstance(keys, np.ndarray):
        return keys
    if all(isinstance(k, (int, np.integer))
           and not isinstance(k, bool) for k in keys):
        return np.asarray(keys, np.int64)
    return np.asarray(list(keys), object)


def route_keys(keys: np.ndarray, parallelism: int,
               max_parallelism: int) -> np.ndarray:
    """Owning subtask per key — EXACTLY the record route (one shared
    implementation: ``core/keygroups.route_raw_keys``).  A query for key
    k lands on the operator instance whose state holds k because both
    sides run the same assignment."""
    from flink_tpu_torch.core.keygroups import route_raw_keys
    return route_raw_keys(keys, parallelism, max_parallelism)

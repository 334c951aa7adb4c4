"""SQL runtime operators: joins, changelog aggregation, Top-N, dedup,
mini-batch bundling, over-aggregates (port of ``flink_tpu/operators/sql_ops.py``).

Analogs of the blink table runtime (``flink-table-runtime-blink``):
``StreamExecJoin`` over bounded inputs (:class:`SqlJoinOperator`),
``StreamingJoinOperator`` (regular equi-join emitting a changelog), the
lookup and temporal joins, ``GroupAggFunction`` with retraction
(:class:`ChangelogGroupAggOperator`, ``+I/-U/+U/-D`` changelog rows),
``AppendOnlyTopNFunction`` / ``RankOperator``,
``DeduplicateKeepFirstRow/KeepLastRow``, the ``bundle/`` mini-batch
operators and the OVER window aggregates.  The joins' equi-join core is
``operators/joins._join_pairs``: host numpy, or the device sorted-merge join
under ``FLINK_TPU_DEVICE_JOIN=1`` on the operator's ``device`` (resolved
when the device lane first runs).  The changelog aggregate keeps its
``[K]`` state on its device (the card unless ``device="cpu"``).  The other
operators are batched columnar numpy, as in JAX, and their snapshots are
plain Python and numpy, so a snapshot taken in either package restores in
the other.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch import DeviceLike, resolve_device
from flink_tpu_torch.core.batch import (LONG_MIN, RecordBatch, StreamElement,
                                        Watermark)
from flink_tpu_torch.operators.base import StreamOperator
from flink_tpu_torch.operators.joins import _join_pairs
from flink_tpu_torch.ops.scatter import (ordered_fold_counts_multi,
                                         total_order)
from flink_tpu_torch.ops.shapes import next_pow2, quantize_pow2
from flink_tpu_torch.state.keyindex import (key_index_kind, make_key_index,
                                            restore_key_index)


def _next_pow2_sql(n: int) -> int:
    return next_pow2(n, 64)


def _infer_column(vals: List[Any]) -> np.ndarray:
    """Row-dict values -> a column with a NATURAL dtype: numeric columns
    must come out float/int (downstream device aggregates cannot consume
    object arrays); None-padded or string columns stay object."""
    if any(v is None for v in vals):
        return np.asarray(vals, object)
    try:
        a = np.asarray(vals)
    except (TypeError, ValueError):
        return np.asarray(vals, object)
    if a.dtype.kind in ("U", "S", "O"):
        return np.asarray(vals, object)
    return a


class SqlJoinOperator(StreamOperator):
    """Bounded-table equi-join (``StreamExecJoin`` over bounded inputs):
    both sides buffer; the join emits once at end-of-input — batch SQL
    semantics.  ``how``: inner / left / right / full."""

    is_two_input = True

    def __init__(self, left_key: str, right_key: str, how: str = "inner",
                 right_rename: Optional[Dict[str, str]] = None,
                 left_columns: Optional[List[str]] = None,
                 right_columns: Optional[List[str]] = None,
                 name: str = "sql-join", device: DeviceLike = None):
        self.device = device
        self.left_key = left_key
        self.right_key = right_key
        self.how = how
        self.right_rename = right_rename or {}
        #: declared schemas: outer joins must emit null-filled columns for an
        #: EMPTY side, which cannot be inferred from received batches
        self.left_columns = left_columns
        self.right_columns = right_columns
        self.name = name
        self._left: List[RecordBatch] = []
        self._right: List[RecordBatch] = []
        self._ended = 0

    def process_batch2(self, batch: RecordBatch,
                       input_index: int) -> List[StreamElement]:
        if len(batch):
            (self._left if input_index == 0 else self._right).append(batch)
        return []

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        return self.process_batch2(batch, 0)

    def end_input(self) -> List[StreamElement]:
        # called once per vertex after ALL inputs ended
        l = RecordBatch.concat(self._left) if self._left else None
        r = RecordBatch.concat(self._right) if self._right else None
        self._left, self._right = [], []
        return self._join(l, r)

    def _rename_right(self, cols: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return {self.right_rename.get(k, k): v for k, v in cols.items()}

    def _join(self, l: Optional[RecordBatch],
              r: Optional[RecordBatch]) -> List[StreamElement]:
        nl = len(l) if l is not None else 0
        nr = len(r) if r is not None else 0
        parts: List[Dict[str, np.ndarray]] = []
        li = ri = np.zeros(0, np.int64)
        if nl and nr:
            li, ri = _join_pairs(np.asarray(l.column(self.left_key)),
                                 np.asarray(r.column(self.right_key)),
                                 self.device)
        lcols = (self.left_columns if self.left_columns is not None
                 else (list(l.columns) if l is not None else []))
        rcols = (self.right_columns if self.right_columns is not None
                 else (list(r.columns) if r is not None else []))
        if li.size:
            cols = {k: np.asarray(v)[li] for k, v in l.columns.items()}
            cols.update(self._rename_right(
                {k: np.asarray(v)[ri] for k, v in r.columns.items()}))
            parts.append(cols)
        if self.how in ("left", "full") and nl:
            unmatched = np.setdiff1d(np.arange(nl), li)
            if unmatched.size:
                cols = {k: np.asarray(v)[unmatched]
                        for k, v in l.columns.items()}
                cols.update(self._rename_right(
                    {k: np.full(unmatched.size, None, object) for k in rcols}))
                parts.append(cols)
        if self.how in ("right", "full") and nr:
            unmatched = np.setdiff1d(np.arange(nr), ri)
            if unmatched.size:
                cols = {k: np.full(unmatched.size, None, object)
                        for k in lcols}
                cols.update(self._rename_right(
                    {k: np.asarray(v)[unmatched]
                     for k, v in r.columns.items()}))
                parts.append(cols)
        if not parts:
            return []
        batches = [RecordBatch(c) for c in parts]
        return [RecordBatch.concat(batches) if len(batches) > 1 else batches[0]]

    def snapshot_state(self) -> Dict[str, Any]:
        def pack(bs):
            if not bs:
                return None
            b = RecordBatch.concat(bs)
            return {k: np.asarray(v) for k, v in b.columns.items()}
        return {"left": pack(self._left), "right": pack(self._right)}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self._left = ([RecordBatch(snap["left"])] if snap.get("left") else [])
        self._right = ([RecordBatch(snap["right"])] if snap.get("right") else [])


class _JoinSideState:
    """One side of an unbounded streaming join: a row-instance table with a
    per-key live index, association counts for outer padding, and optional
    processing-time TTL (``JoinRecordStateView`` /
    ``OuterJoinRecordStateView`` analog — state rows + numOfAssociations)."""

    def __init__(self, columns: List[str], key_col: str):
        self.columns = list(columns)
        self.key_at = self.columns.index(key_col)
        self.rows: List[Optional[tuple]] = []   # row tuples; None = freed
        self.assoc: List[int] = []              # matches on the other side
        self.ts: List[int] = []                 # last-touch ms (TTL)
        self.by_key: Dict[Any, List[int]] = {}  # key -> live row indices
        self.free: List[int] = []

    def add(self, row: tuple, assoc: int, now_ms: int) -> int:
        if self.free:
            i = self.free.pop()
            self.rows[i] = row
            self.assoc[i] = assoc
            self.ts[i] = now_ms
        else:
            i = len(self.rows)
            self.rows.append(row)
            self.assoc.append(assoc)
            self.ts.append(now_ms)
        self.by_key.setdefault(row[self.key_at], []).append(i)
        return i

    def remove_one(self, row: tuple) -> Optional[int]:
        """Retract ONE instance equal to ``row``; returns its index (its
        assoc count is still readable) or None if no instance is live."""
        key = row[self.key_at]
        idxs = self.by_key.get(key)
        if not idxs:
            return None
        for pos, i in enumerate(idxs):
            if self.rows[i] == row:
                idxs.pop(pos)
                if not idxs:
                    del self.by_key[key]
                self.rows[i] = None
                self.free.append(i)
                return i
        return None

    def matches(self, key: Any,
                cutoff_ms: Optional[int] = None) -> List[int]:
        """Live rows under ``key``; with a TTL cutoff, expired rows are
        filtered at access time (exact semantics) while ``expire`` sweeps
        reclaim their memory on an amortized cadence."""
        idxs = self.by_key.get(key, [])
        if cutoff_ms is None:
            return idxs
        return [i for i in idxs if self.ts[i] >= cutoff_ms]

    def expire(self, cutoff_ms: int) -> int:
        """Drop rows last touched before ``cutoff_ms`` (state TTL: silent
        eviction, like the reference's StateTtlConfig on join state — no
        retractions are emitted for expired rows)."""
        dropped = 0
        for key in list(self.by_key):
            idxs = self.by_key[key]
            keep = []
            for i in idxs:
                if self.ts[i] < cutoff_ms:
                    self.rows[i] = None
                    self.free.append(i)
                    dropped += 1
                else:
                    keep.append(i)
            if keep:
                self.by_key[key] = keep
            else:
                del self.by_key[key]
        return dropped

    def snapshot(self) -> Dict[str, Any]:
        live = [i for i, r in enumerate(self.rows) if r is not None]
        return {
            "cols": {c: np.asarray([self.rows[i][j] for i in live], object)
                     for j, c in enumerate(self.columns)},
            "assoc": np.asarray([self.assoc[i] for i in live], np.int64),
            "ts": np.asarray([self.ts[i] for i in live], np.int64),
        }

    def restore(self, snap: Dict[str, Any]) -> None:
        cols = [snap["cols"][c] for c in self.columns]
        n = len(cols[0]) if cols else 0
        self.rows = [tuple(col[i] for col in cols) for i in range(n)]
        self.assoc = [int(a) for a in snap["assoc"]]
        self.ts = [int(t) for t in snap["ts"]]
        self.by_key = {}
        self.free = []
        for i, row in enumerate(self.rows):
            self.by_key.setdefault(row[self.key_at], []).append(i)


class StreamingJoinOperator(StreamOperator):
    """Unbounded two-stream equi-join emitting an incremental CHANGELOG —
    the ``StreamingJoinOperator`` analog
    (``flink-table-runtime-blink/.../join/stream/StreamingJoinOperator.java:36``
    with the ``JoinRecordStateView`` association counting of
    ``OuterJoinRecordStateView.java``).

    Both sides live in keyed state forever (or until ``state_ttl_ms``); each
    arriving row emits joined rows immediately.  The ``op`` output column
    carries the change kind: ``+I`` insert, ``-D`` delete, and the outer-join
    padding transitions ride ``-U``/``+U`` pairs — when a null-padded outer
    row gains its FIRST match the padded row downgrades out (``-U``) and the
    joined row upgrades in (``+U``); losing the LAST match reverses it.
    Inputs may themselves be changelogs: a batch with an ``op`` column
    retracts on ``-D``/``-U`` and accumulates on ``+I``/``+U`` (RowKind
    folding, ``AbstractStreamingJoinOperator.java``).

    Append-only inner joins take a vectorized fast path (no association
    bookkeeping is needed without padding): incoming batch keys hash-join
    against the stored other side via ``_join_pairs`` in one shot.
    """

    is_two_input = True

    def __init__(self, left_key: str, right_key: str, how: str = "inner",
                 right_rename: Optional[Dict[str, str]] = None,
                 left_columns: Optional[List[str]] = None,
                 right_columns: Optional[List[str]] = None,
                 state_ttl_ms: int = 0,
                 name: str = "streaming-join", device: DeviceLike = None):
        if left_columns is None or right_columns is None:
            raise ValueError("streaming join requires declared schemas "
                             "(outer padding cannot be inferred)")
        self.left_key = left_key
        self.right_key = right_key
        self.how = how
        self.right_rename = right_rename or {}
        self.left_columns = list(left_columns)
        self.right_columns = list(right_columns)
        self.state_ttl_ms = state_ttl_ms
        self.name = name
        self.device = device
        self._left = _JoinSideState(self.left_columns, left_key)
        self._right = _JoinSideState(self.right_columns, right_key)
        #: retractions for rows never accumulated (e.g. expired by TTL) are
        #: dropped, counted here (the reference logs & skips the same way)
        self.stale_retractions = 0
        #: last full-expire sweep time: expiry is amortized (a sweep per
        #: ttl/4, like the reference's timer-driven StateTtlConfig), never
        #: an O(total state) scan on every batch
        self._last_expire_ms = 0
        self._out_columns = (["op"] + self.left_columns
                             + [self.right_rename.get(c, c)
                                for c in self.right_columns])

    # -- helpers -------------------------------------------------------------
    def _now_ms(self) -> int:
        import time
        return int(time.time() * 1000)

    def _outer(self, side: int) -> bool:
        """Is ``side`` (0=left, 1=right) an outer side (emits padding)?"""
        return self.how in (("left", "full") if side == 0
                            else ("right", "full"))

    def _cutoff(self, now_ms: int) -> Optional[int]:
        return (now_ms - self.state_ttl_ms) if self.state_ttl_ms > 0 else None

    def _joined(self, op: str, lrow: Optional[tuple],
                rrow: Optional[tuple]) -> tuple:
        l = lrow if lrow is not None else (None,) * len(self.left_columns)
        r = rrow if rrow is not None else (None,) * len(self.right_columns)
        return (op,) + l + r

    def _to_batch(self, out: List[tuple]) -> List[StreamElement]:
        if not out:
            return []
        cols = {c: np.asarray([row[j] for row in out], object)
                for j, c in enumerate(self._out_columns)}
        return [RecordBatch(cols)]

    # -- per-row semantics ---------------------------------------------------
    def _accumulate(self, side: int, row: tuple, out: List[tuple],
                    now_ms: int) -> None:
        own = self._left if side == 0 else self._right
        other = self._right if side == 0 else self._left
        pair = ((lambda o, a, b: self._joined(o, a, b)) if side == 0
                else (lambda o, a, b: self._joined(o, b, a)))
        matches = list(other.matches(row[own.key_at], self._cutoff(now_ms)))
        if matches:
            for m in matches:
                mrow = other.rows[m]
                if self._outer(1 - side) and other.assoc[m] == 0:
                    # the other side's null-padded row gains its first match:
                    # downgrade the padding out, upgrade the joined row in
                    out.append(pair("-U", None, mrow))
                    out.append(pair("+U", row, mrow))
                else:
                    out.append(pair("+I", row, mrow))
                other.assoc[m] += 1
                other.ts[m] = now_ms
        elif self._outer(side):
            out.append(pair("+I", row, None))
        own.add(row, len(matches), now_ms)

    def _retract(self, side: int, row: tuple, out: List[tuple],
                 now_ms: int) -> None:
        own = self._left if side == 0 else self._right
        other = self._right if side == 0 else self._left
        pair = ((lambda o, a, b: self._joined(o, a, b)) if side == 0
                else (lambda o, a, b: self._joined(o, b, a)))
        if own.remove_one(row) is None:
            self.stale_retractions += 1
            return
        matches = list(other.matches(row[own.key_at], self._cutoff(now_ms)))
        if matches:
            for m in matches:
                mrow = other.rows[m]
                other.assoc[m] -= 1
                other.ts[m] = now_ms
                if self._outer(1 - side) and other.assoc[m] == 0:
                    # last match gone: the joined row downgrades out, the
                    # null-padded row upgrades back in
                    out.append(pair("-U", row, mrow))
                    out.append(pair("+U", None, mrow))
                else:
                    out.append(pair("-D", row, mrow))
        elif self._outer(side):
            out.append(pair("-D", row, None))

    # -- batch entry ---------------------------------------------------------
    def process_batch2(self, batch: RecordBatch,
                       input_index: int) -> List[StreamElement]:
        if len(batch) == 0:
            return []
        now = self._now_ms()
        if self.state_ttl_ms > 0 \
                and now - self._last_expire_ms >= self.state_ttl_ms // 4:
            self._last_expire_ms = now
            cutoff = now - self.state_ttl_ms
            self._left.expire(cutoff)
            self._right.expire(cutoff)
        own = self._left if input_index == 0 else self._right
        col_names = own.columns
        data = [np.asarray(batch.column(c)) for c in col_names]
        ops = (np.asarray(batch.column("op"))
               if "op" in batch.columns else None)
        out: List[tuple] = []
        if ops is None and self.how == "inner":
            self._accumulate_append_inner(input_index, data, now, out)
            return self._to_batch(out)
        n = len(batch)
        for i in range(n):
            row = tuple(col[i] for col in data)
            op = "+I" if ops is None else str(ops[i])
            if op in ("+I", "+U"):
                self._accumulate(input_index, row, out, now)
            elif op in ("-D", "-U"):
                self._retract(input_index, row, out, now)
            else:
                raise ValueError(f"unknown changelog op {op!r}")
        return self._to_batch(out)

    def _accumulate_append_inner(self, side: int, data: List[np.ndarray],
                                 now_ms: int, out: List[tuple]) -> None:
        """Vectorized append-only inner path: one hash join of the incoming
        batch against the stored other side (no padding → no association
        counts to maintain)."""
        own = self._left if side == 0 else self._right
        other = self._right if side == 0 else self._left
        keys = data[own.key_at]
        cut = self._cutoff(now_ms)
        cand = [i for k in dict.fromkeys(keys.tolist())
                for i in other.matches(k, cut)]
        if cand:
            other_keys = np.asarray([other.rows[i][other.key_at]
                                     for i in cand], object)
            bi, ci = _join_pairs(keys, other_keys, self.device)
            for b, c in zip(bi.tolist(), ci.tolist()):
                row = tuple(col[b] for col in data)
                mrow = other.rows[cand[c]]
                other.ts[cand[c]] = now_ms   # TTL touch, same as slow path
                out.append(self._joined("+I", row, mrow) if side == 0
                           else self._joined("+I", mrow, row))
        for i in range(len(keys)):
            own.add(tuple(col[i] for col in data), 0, now_ms)

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        return self.process_batch2(batch, 0)

    # -- lifecycle -----------------------------------------------------------
    def snapshot_state(self) -> Dict[str, Any]:
        return {"left": self._left.snapshot(),
                "right": self._right.snapshot(),
                "stale_retractions": self.stale_retractions}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self._left.restore(snap["left"])
        self._right.restore(snap["right"])
        self.stale_retractions = int(snap.get("stale_retractions", 0))


class LookupJoinOperator(StreamOperator):
    """Dimension (lookup) join — the ``StreamExecLookupJoin`` /
    ``LookupJoinRunner`` analog: each probe row looks its key up in an
    EXTERNAL system (e.g. the wire-real Postgres connector) through a
    TTL'd cache; the dimension is observed at processing time
    (``FOR SYSTEM_TIME AS OF o.proctime`` semantics).

    ``lookup_fn(key) -> list[dict]`` returns the dimension rows for a key
    (empty list = no match).  The cache bounds external round-trips:
    entries expire after ``cache_ttl_ms`` and the cache holds at most
    ``max_cache_rows`` keys (LRU eviction), mirroring
    ``LookupCacheManager`` / ``table.exec.lookup.cache`` options."""

    def __init__(self, key_column: str,
                 lookup_fn: Callable[[Any], List[dict]],
                 right_columns: List[str],
                 right_rename: Optional[Dict[str, str]] = None,
                 how: str = "inner",
                 cache_ttl_ms: int = 60_000,
                 max_cache_rows: int = 10_000,
                 name: str = "lookup-join"):
        if how not in ("inner", "left"):
            raise ValueError("lookup join supports INNER and LEFT only")
        self.key_column = key_column
        self.lookup_fn = lookup_fn
        self.right_columns = list(right_columns)
        self.right_rename = right_rename or {}
        self.how = how
        self.cache_ttl_ms = cache_ttl_ms
        self.max_cache_rows = max_cache_rows
        self.name = name
        #: key -> (fetched_at_ms, rows); insertion order doubles as LRU
        self._cache: Dict[Any, Tuple[int, List[dict]]] = {}
        self.cache_hits = 0
        self.cache_misses = 0

    def _probe(self, key: Any, now_ms: int) -> List[dict]:
        hit = self._cache.get(key)
        if hit is not None and (self.cache_ttl_ms <= 0
                                or now_ms - hit[0] < self.cache_ttl_ms):
            self.cache_hits += 1
            self._cache[key] = self._cache.pop(key)   # LRU touch
            return hit[1]
        self.cache_misses += 1
        rows = list(self.lookup_fn(key))
        self._cache.pop(key, None)
        self._cache[key] = (now_ms, rows)
        while len(self._cache) > self.max_cache_rows:
            self._cache.pop(next(iter(self._cache)))
        return rows

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        import time
        if len(batch) == 0:
            return []
        now = int(time.time() * 1000)
        keys = np.asarray(batch.column(self.key_column))
        lcols = list(batch.columns)
        larrs = [np.asarray(batch.column(c)) for c in lcols]
        by_key = {k: self._probe(k, now)
                  for k in dict.fromkeys(keys.tolist())}
        out: List[dict] = []
        for i in range(len(batch)):
            matches = by_key[keys[i] if not isinstance(keys[i], np.generic)
                             else keys[i].item()]
            lrow = {c: a[i] for c, a in zip(lcols, larrs)}
            if matches:
                for m in matches:
                    row = dict(lrow)
                    for c in self.right_columns:
                        row[self.right_rename.get(c, c)] = m.get(c)
                    out.append(row)
            elif self.how == "left":
                row = dict(lrow)
                for c in self.right_columns:
                    row[self.right_rename.get(c, c)] = None
                out.append(row)
        if not out:
            return []
        cols = {c: _infer_column([r[c] for r in out]) for c in out[0]}
        return [RecordBatch(cols)]

    # the cache is NOT state: a restore re-probes the external system (the
    # dimension may have changed; the reference's cache is also transient)
    def snapshot_state(self) -> Dict[str, Any]:
        return {}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self._cache = {}


class TemporalJoinOperator(StreamOperator):
    """Event-time temporal (versioned-table) join — the
    ``StreamExecTemporalJoin.java:67`` / ``TemporalRowTimeJoinOperator``
    analog: the right side is a VERSIONED table (append stream of versions
    keyed by ``right_key``, version time = ``right_time_column``); each
    left row at time t joins the latest right version with
    ``version_ts <= t``.  Left rows buffer until the watermark passes
    their time (both inputs' watermarks merge through the two-input
    valve), so late-arriving versions still win; versions older than the
    one valid at the watermark are pruned (state cleanup,
    ``TemporalRowTimeJoinOperator.cleanupState``)."""

    is_two_input = True

    def __init__(self, left_key: str, right_key: str,
                 left_time_column: str, right_time_column: str,
                 right_columns: List[str],
                 right_rename: Optional[Dict[str, str]] = None,
                 how: str = "inner",
                 name: str = "temporal-join"):
        if how not in ("inner", "left"):
            raise ValueError("temporal join supports INNER and LEFT only")
        self.left_key = left_key
        self.right_key = right_key
        self.left_time_column = left_time_column
        self.right_time_column = right_time_column
        self.right_columns = list(right_columns)
        self.right_rename = right_rename or {}
        self.how = how
        self.name = name
        #: right: key -> (sorted version ts list, parallel row list)
        self._versions: Dict[Any, Tuple[List[int], List[dict]]] = {}
        #: left rows waiting for the watermark: [(t, row), ...]
        self._pending: List[Tuple[int, dict]] = []
        self.watermark = LONG_MIN
        self._wm_calls = 0

    def process_batch2(self, batch: RecordBatch,
                       input_index: int) -> List[StreamElement]:
        import bisect
        if len(batch) == 0:
            return []
        cols = list(batch.columns)
        arrs = [np.asarray(batch.column(c)) for c in cols]
        rows = [{c: a[i] for c, a in zip(cols, arrs)}
                for i in range(len(batch))]
        if input_index == 1:
            for r in rows:
                vts = int(r[self.right_time_column])
                ts_list, row_list = self._versions.setdefault(
                    r[self.right_key], ([], []))
                i = bisect.bisect_right(ts_list, vts)
                ts_list.insert(i, vts)
                row_list.insert(i, r)
            return []
        for r in rows:
            self._pending.append((int(r[self.left_time_column]), r))
        return []

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        return self.process_batch2(batch, 0)

    def process_watermark(self, watermark: Watermark) -> List[StreamElement]:
        self.watermark = max(self.watermark, watermark.timestamp)
        self._wm_calls += 1
        if self._wm_calls % 64 == 0:
            # amortized sweep for keys never probed (probe-time pruning
            # below covers the active ones) — never a full scan per
            # watermark on the hot path
            self._prune_all(self.watermark)
        return self._emit_ready(self.watermark)

    def end_input(self) -> List[StreamElement]:
        return self._emit_ready(2 ** 62)

    def _emit_ready(self, up_to: int) -> List[StreamElement]:
        import bisect
        ready = [(t, r) for t, r in self._pending if t <= up_to]
        if not ready:
            return []
        self._pending = [(t, r) for t, r in self._pending if t > up_to]
        ready.sort(key=lambda e: e[0])
        out: List[dict] = []
        out_ts: List[int] = []
        probed = set()
        for t, lrow in ready:
            key = lrow[self.left_key]
            probed.add(key)
            entry = self._versions.get(key)
            i = bisect.bisect_right(entry[0], t) if entry else 0
            if i > 0:
                vrow = entry[1][i - 1]
                row = dict(lrow)
                for c in self.right_columns:
                    row[self.right_rename.get(c, c)] = vrow.get(c)
            elif self.how == "left":
                row = dict(lrow)
                for c in self.right_columns:
                    row[self.right_rename.get(c, c)] = None
            else:
                continue
            out.append(row)
            out_ts.append(t)
        if up_to < 2 ** 62:
            for key in probed:        # lazy per-key state cleanup
                self._prune_key(key, up_to)
        if not out:
            return []
        cols = {c: _infer_column([r[c] for r in out]) for c in out[0]}
        return [RecordBatch(cols, timestamps=np.asarray(out_ts, np.int64))]

    def _prune_key(self, key, wm: int) -> None:
        """Drop versions older than the one valid AT the watermark — they
        can never be joined again (``TemporalRowTimeJoinOperator``'s state
        cleanup)."""
        import bisect
        entry = self._versions.get(key)
        if not entry:
            return
        ts_list, row_list = entry
        cut = bisect.bisect_right(ts_list, wm) - 1
        if cut > 0:
            del ts_list[:cut]
            del row_list[:cut]

    def _prune_all(self, wm: int) -> None:
        for key in list(self._versions):
            self._prune_key(key, wm)

    def snapshot_state(self) -> Dict[str, Any]:
        return {"versions": {k: (list(ts), list(rows))
                             for k, (ts, rows) in self._versions.items()},
                "pending": list(self._pending),
                "watermark": self.watermark}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self._versions = {k: (list(v[0]), list(v[1]))
                          for k, v in snap["versions"].items()}
        self._pending = list(snap["pending"])
        self.watermark = snap["watermark"]


def _scatter_extremum(init: float, inv, vals, U: int, mode: str):
    """Per-group IEEE minimum/maximum of ``vals`` over ``init`` (XLA's
    scatter min/max, which order -0.0 below +0.0), reduced on int32 total-
    order keys so neither device's float ``amin``/``amax`` picks a zero's
    sign by row order."""
    keys = total_order(torch.full((U,), init, dtype=torch.float32,
                                   device=vals.device))
    keys.scatter_reduce_(0, inv, total_order(vals),
                         reduce="amin" if mode == "min" else "amax",
                         include_self=True)
    return total_order(keys).view(torch.float32)


def _seg_extremum(hi, lo, inv, U: int, mode: str, identity: float):
    """Per-batch segment min/max of Dekker pairs (JAX's ``_seg_reduce_pair``
    for min/max): the hi words' extremum per group, then the lo words of the
    rows whose hi attained it (others masked to the identity).  Neither
    result depends on the order of the rows."""
    inf = float("inf") if mode == "min" else float("-inf")
    hi_x = _scatter_extremum(identity, inv, hi, U, mode)
    lo_x = _scatter_extremum(inf, inv, torch.where(hi == hi_x[inv], lo, inf),
                             U, mode)
    # identity segments (no rows): lo back to 0 so hi+lo stays finite
    return hi_x, torch.where(torch.isfinite(lo_x), lo_x, 0.0)


def _lex_pick(ah, al, bh, bl, mode: str):
    """Element-wise lexicographic min/max over Dekker pairs (hi, lo):
    normalized pairs order exactly like the f64 values they represent."""
    if mode == "min":
        take_a = (ah < bh) | ((ah == bh) & (al <= bl))
    else:
        take_a = (ah > bh) | ((ah == bh) & (al >= bl))
    return torch.where(take_a, ah, bh), torch.where(take_a, al, bl)


def changelog_update_step(state, modes, identities, uniq, inv, values):
    """One micro-batch of :class:`ChangelogGroupAggOperator` on the state's
    device (JAX's jitted ``_update_step_impl``), the state updated in place.

    ``state``: the ``2C`` f32 ``[K]`` planes, (hi, lo) per aggregate column;
    ``modes``/``identities``: per column ``add``/``min``/``max`` and its
    identity; ``uniq``: int64 ``[U]`` distinct slots of the batch, ascending;
    ``inv``: int64 ``[Bp]`` each row's group in ``uniq`` (pad rows 0);
    ``values``: f32 ``[2C, Bp]`` the rows' (hi, lo) words per column.

    An ``add`` column combines its batch into its touched slots as a
    double-single 2Sum.  Its words fold in row order through
    ``ordered_fold_counts_multi`` (on the card ``csrc/scatter_fold.cu``; on
    the CPU ``index_add_``, sequential like XLA's CPU scatter), in two
    launches for all the ``add`` columns: the hi words into zeros (the
    partial ``phi``), then the lo words straight into ``lo + e`` (``e`` the
    exact error of ``hi + phi``).  That second fold is the arithmetic JAX's
    step really runs: XLA rewrites its ``(lo + plo) + e``, with ``plo`` the
    lo words' scatter-add into zeros, into a scatter-add of the lo words
    into ``lo + e``, which rounds differently.  min/max reduce through
    :func:`_seg_extremum` and combine by the lexicographic pick.  Returns
    f32 ``[2, 2C, U]``: the touched slots' old and new words."""
    U = int(uniq.shape[0])
    dev = uniq.device
    adds = [j for j, m in enumerate(modes) if m == "add"]
    counts = torch.zeros(U, dtype=torch.int32, device=dev)   # not read

    def fold(planes, word):
        ordered_fold_counts_multi(
            [(planes, counts, [values[2 * j + word] for j in adds])], inv,
            ("add",) * len(planes))

    phi = [torch.zeros(U, dtype=torch.float32, device=dev) for _ in adds]
    if adds:
        fold(phi, 0)
    out = torch.empty((2, len(state), U), dtype=torch.float32, device=dev)
    pending = []
    for j, mode in enumerate(modes):
        hi_arr, lo_arr = state[2 * j], state[2 * j + 1]
        hi, lo = hi_arr[uniq], lo_arr[uniq]
        out[0, 2 * j], out[0, 2 * j + 1] = hi, lo
        if mode == "add":
            # 2Sum: the exact error of hi + phi
            p = phi[adds.index(j)]
            s = hi + p
            v = s - hi
            e = (hi - (s - v)) + (p - v)
            pending.append((j, s, lo + e))
            continue
        phi_x, plo_x = _seg_extremum(values[2 * j], values[2 * j + 1], inv,
                                     U, mode, identities[j])
        nh, nl = _lex_pick(hi, lo, phi_x, plo_x, mode)
        hi_arr[uniq], lo_arr[uniq] = nh, nl
        out[1, 2 * j], out[1, 2 * j + 1] = nh, nl
    if adds:
        fold([lo2 for _, _, lo2 in pending], 1)
    for j, s, lo2 in pending:
        nh = s + lo2
        nl = lo2 - (nh - s)
        state[2 * j][uniq], state[2 * j + 1][uniq] = nh, nl
        out[1, 2 * j], out[1, 2 * j + 1] = nh, nl
    return out


def changelog_rows(key_column: str, names: List[str], keys: np.ndarray,
                   olds: List[np.ndarray], news: List[np.ndarray],
                   first_op: np.ndarray, first_old: np.ndarray,
                   pair: np.ndarray) -> Optional[RecordBatch]:
    """The changelog of one batch's ``U`` touched groups, built with array
    ops in JAX's order (its loop over the groups, one dict per row): group
    by group, a first row where ``first_op`` is set (``"+I"``, ``"-D"`` or
    ``"-U"``, from the old values where ``first_old``, else the new), and
    after it a ``"+U"`` row of the new values where ``pair``.  Columns
    ``op`` (``<U2``), the key and ``names`` (f64); None when no group
    emits.  The key column has the keys' dtype, except that object keys
    take the dtype numpy infers from their values (strings come out
    ``<U``), as JAX's rows do: it builds them through
    ``RecordBatch.from_rows``."""
    reps = (first_op != "").astype(np.int64) + pair
    total = int(reps.sum())
    if not total:
        return None
    g = np.repeat(np.arange(keys.size), reps)
    second = np.zeros(total, bool)
    second[np.cumsum(reps)[pair] - 1] = True
    old = ~second & first_old[g]
    key_col = keys[g]
    if key_col.dtype == object:
        key_col = np.asarray(key_col.tolist())
    cols = {"op": np.where(second, "+U", first_op[g]).astype("<U2"),
            key_column: key_col}
    for nm, o, n in zip(names, olds, news):
        cols[nm] = np.where(old, o[g], n[g])
    return RecordBatch(cols)


class ChangelogGroupAggOperator(StreamOperator):
    """Non-windowed group aggregate emitting a CHANGELOG (retraction) stream
    — the ``StreamExecGroupAggregate`` / ``GroupAggFunction`` analog
    (``flink-table-runtime-blink/.../operators/aggregate/``).

    Group state is a dense ``[K]`` pair of f32 planes per aggregate on the
    operator's device; each micro-batch is one :func:`changelog_update_step`
    (segment-reduce the batch into per-group partials, gather the OLD
    values, combine, scatter the NEW ones back), and only the ``[U]``
    touched groups' old/new words come back to the host, which is exactly
    the set changelog semantics must emit.  The host emits ``+I`` for groups
    whose dense slot id is new (slot ids are insertion-ordered, so "new
    since the previous batch" is a host-known comparison), ``-U``/``+U``
    pairs for changed ones.  The ``op`` column carries the change kind.
    Slots come from ``state/keyindex.make_key_index`` (the C keydict for
    integer keys, an ``ObjectKeyIndex`` for others).  ``step_stats`` counts steps, rows,
    touched groups and the bytes each step moved over the bus."""

    #: combine modes per aggregate kind
    _MODES = {"sum": "add", "count": "add", "min": "min", "max": "max"}

    def __init__(self, key_column: str, agg_columns: Dict[str, Tuple[str, str]],
                 name: str = "changelog-group-agg",
                 initial_capacity: int = 1 << 10,
                 consume_retractions: bool = False,
                 device: DeviceLike = None):
        """agg_columns: out_name -> (input column, how in sum/count/min/max).

        ``consume_retractions=True``: the INPUT is itself a changelog (an
        ``op`` column with +I/-U/+U/-D); retraction rows contribute NEGATED
        values, a hidden per-group row count detects group deletion (``-D``
        emitted when it reaches zero) and re-insertion (``+I``).  Only
        invertible aggregates (sum/count) can consume retractions."""
        for out, (_c, how) in agg_columns.items():
            if how not in self._MODES:
                raise ValueError(f"unsupported changelog aggregate {how!r}")
        self.consume_retractions = consume_retractions
        self.output_names = list(agg_columns)
        if consume_retractions:
            bad = [o for o, (_c, how) in agg_columns.items()
                   if self._MODES[how] != "add"]
            if bad:
                raise ValueError(
                    f"aggregates {bad} cannot consume retractions "
                    f"(min/max are not invertible); use sum/count")
            agg_columns = dict(agg_columns)
            agg_columns["__rows"] = (None, "count")   # hidden liveness count
        self.key_column = key_column
        self.agg_columns = agg_columns
        self.name = name
        self.device = resolve_device(device)
        self._K = initial_capacity
        self.key_index = None
        self._state = None  # list of f32 [K] planes, (hi, lo) per column
        self.step_stats = {"steps": 0, "rows": 0, "groups": 0,
                           "h2d_bytes": 0, "d2h_bytes": 0}

    def _identity(self, how: str) -> float:
        return 0.0 if how in ("sum", "count") else (
            np.inf if how == "min" else -np.inf)

    def _alloc(self, K: int):
        """TWO f32 words (hi, lo) per column.  sum/count: double-single
        (compensated) accumulation; min/max: Dekker-split pairs combined
        lexicographically.  Both keep ~48 bits of precision in f32 words:
        a count or an integer-valued min/max is exact up to 2^48."""
        arrs = []
        for out, (_c, how) in self.agg_columns.items():
            arrs.append(torch.full((K,), self._identity(how),
                                   dtype=torch.float32, device=self.device))
            arrs.append(torch.zeros(K, dtype=torch.float32,
                                    device=self.device))  # low word
        return arrs

    def _ensure(self, needed: int):
        if self._state is None:
            while self._K < needed:
                self._K <<= 1
            self._state = self._alloc(self._K)
            return
        if needed <= self._K:
            return
        oldK = self._state[0].shape[0]
        while self._K < needed:
            self._K <<= 1
        fresh = self._alloc(self._K)
        for f, o in zip(fresh, self._state):
            f[:oldK] = o
        self._state = fresh

    #: per-batch partials reduce in plain f32 (exact for counts up to 2^24
    #: per batch); batches beyond this bound chunk so the within-chunk
    #: reduction stays exact and the double-single merge carries precision
    #: across chunks
    _MAX_CHUNK = 1 << 22

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        if len(batch) == 0:
            return []
        if len(batch) > self._MAX_CHUNK:
            out: List[StreamElement] = []
            n = len(batch)
            idx = np.arange(n)
            for lo in range(0, n, self._MAX_CHUNK):
                m = (idx >= lo) & (idx < lo + self._MAX_CHUNK)
                out.extend(self.process_batch(batch.select(m)))
            return out
        keys = np.asarray(batch.column(self.key_column))
        if self.key_index is None:
            self.key_index = make_key_index(keys[0] if keys.ndim else keys)
        prev_n = self.key_index.num_keys
        slots = self.key_index.lookup_or_insert(keys)
        self._ensure(self.key_index.num_keys)
        uniq_slots, inv = np.unique(slots, return_inverse=True)
        U = int(uniq_slots.size)
        # the batch is padded (quantized) as JAX pads it: padding rows carry
        # each column's identity and inv=0, a contribution to group 0 that
        # changes no bit but a -0.0 low word's sign, as in JAX.  JAX also
        # pads the groups to a power of two with a slot its scatter drops;
        # the port computes the U real groups only, which JAX's are
        B = len(batch)
        Bp = quantize_pow2(B, floor=64, steps=4)
        inv_p = np.zeros(Bp, np.int64)
        inv_p[:B] = inv.reshape(-1)
        sign = None
        if self.consume_retractions and "op" in batch.columns:
            # retraction rows contribute negated values (invertible aggs
            # only — enforced at construction)
            ops = np.asarray(batch.column("op"))
            sign = np.where(np.isin(ops, ["-D", "-U"]), -1.0, 1.0)
        words = np.empty((2 * len(self.agg_columns), Bp), np.float32)
        modes, idents = [], []
        for j, (out, (col, how)) in enumerate(self.agg_columns.items()):
            mode = self._MODES[how]
            modes.append(mode)
            idents.append(self._identity(how))
            # Dekker split on the host: hi = f32(v), lo = f32(v - hi) — the
            # pair carries ~48 bits, so integer inputs above 2^24 stay exact
            # through min/max and into compensated sums
            v64 = np.full(Bp, 0.0 if mode == "add" else self._identity(how),
                          np.float64)
            vals = (1.0 if col is None
                    else np.asarray(batch.column(col), np.float64))
            v64[:B] = vals * sign if sign is not None else vals
            vhi = v64.astype(np.float32)
            with np.errstate(invalid="ignore"):  # inf - inf pads -> 0 below
                vlo = (v64 - vhi.astype(np.float64)).astype(np.float32)
            vlo[~np.isfinite(vlo)] = 0.0
            words[2 * j], words[2 * j + 1] = vhi, vlo
        dev = self.device
        uniq_t = torch.from_numpy(uniq_slots.astype(np.int64)).to(dev)
        out_t = changelog_update_step(
            self._state, modes, idents, uniq_t,
            torch.from_numpy(inv_p).to(dev), torch.from_numpy(words).to(dev))
        got = out_t.cpu().numpy()
        st = self.step_stats
        st["steps"] += 1
        st["rows"] += B
        st["groups"] += U
        st["h2d_bytes"] += uniq_t.numel() * 8 + inv_p.nbytes + words.nbytes
        st["d2h_bytes"] += got.nbytes
        # (hi, lo) pairs collapse to f64 (recovering the compensated
        # precision)
        wide = got.astype(np.float64)
        olds_f, news_f = ([w[i] + w[i + 1] for i in range(0, len(w), 2)]
                          for w in wide)
        names = list(self.agg_columns)
        keys_u = self.key_index.reverse_keys()[uniq_slots]
        if self.consume_retractions:
            return self._emit_retract_mode(names, keys_u, olds_f, news_f, U)
        is_new = uniq_slots >= prev_n
        changed = ~is_new & np.logical_or.reduce(
            [o != n for o, n in zip(olds_f, news_f)])
        first = np.where(is_new, "+I", np.where(changed, "-U", ""))
        out = changelog_rows(self.key_column, names, keys_u, olds_f, news_f,
                             first, changed, changed)
        return [] if out is None else [out]

    def _emit_retract_mode(self, names, keys_u, olds_f, news_f,
                           U: int) -> List[StreamElement]:
        """Changelog-consuming emission: the hidden ``__rows`` count drives
        group liveness — 0→n emits ``+I``, n→0 emits ``-D`` (with the OLD
        values, the row downstream must revoke), live-and-changed emits the
        ``-U``/``+U`` pair (``GroupAggFunction`` with
        ``countIsZero``/``firstRow`` logic)."""
        ri = names.index("__rows")
        out_idx = [j for j, nm in enumerate(names) if nm != "__rows"]
        old_r, new_r = olds_f[ri], news_f[ri]
        val_changed = (np.logical_or.reduce(
            [olds_f[j] != news_f[j] for j in out_idx])
            if out_idx else np.zeros(U, bool))
        appear = (old_r <= 0) & (new_r > 0)
        disappear = (old_r > 0) & (new_r <= 0)
        update = (old_r > 0) & (new_r > 0) & val_changed
        first = np.where(appear, "+I", np.where(
            disappear, "-D", np.where(update, "-U", "")))
        out = changelog_rows(self.key_column, self.output_names, keys_u,
                             [olds_f[j] for j in out_idx],
                             [news_f[j] for j in out_idx], first,
                             disappear | update, update)
        return [] if out is None else [out]

    def snapshot_state(self) -> Dict[str, Any]:
        snap: Dict[str, Any] = {}
        if self.key_index is not None:
            n = self.key_index.num_keys
            snap["key_index"] = self.key_index.snapshot()
            snap["key_index_kind"] = key_index_kind(self.key_index)
            if self._state is not None:
                words = torch.stack([a[:n] for a in self._state]).cpu().numpy()
                snap["state"] = list(words)
        return snap

    def restore_state(self, snap: Dict[str, Any]) -> None:
        if "groups" in snap:  # legacy host-dict snapshot format
            groups = snap["groups"]
            if groups:
                keys = np.asarray(list(groups))
                self.key_index = make_key_index(keys[0])
                slots = torch.from_numpy(self.key_index.lookup_or_insert(
                    keys).astype(np.int64)).to(self.device)
                self._ensure(self.key_index.num_keys)
                si = 0
                for out, (_c, how) in self.agg_columns.items():
                    vals = np.asarray([groups[k][out] for k in groups],
                                      np.float32)
                    self._state[si][slots] = torch.from_numpy(vals).to(
                        self.device)
                    si += 2  # lo word stays 0 (normalized pair)
            return
        if "key_index" not in snap:
            return
        self.key_index = restore_key_index(snap["key_index"],
                                           snap["key_index_kind"])
        n = self.key_index.num_keys
        self._state = None
        self._ensure(max(n, 1))
        if "state" in snap:
            arrs = list(snap["state"])
            if len(arrs) != 2 * len(self.agg_columns):
                # pre-r3 layout: min/max columns had a single word — insert
                # zero low words so every column is an (hi, lo) pair
                upgraded, i = [], 0
                for out, (_c, how) in self.agg_columns.items():
                    upgraded.append(arrs[i])
                    if self._MODES[how] == "add":
                        upgraded.append(arrs[i + 1])
                        i += 2
                    else:
                        upgraded.append(np.zeros_like(arrs[i]))
                        i += 1
                arrs = upgraded
            for a, s in zip(self._state, arrs):
                a[:n] = torch.from_numpy(np.array(s, np.float32)).to(
                    self.device)


class TopNOperator(StreamOperator):
    """Streaming Top-N per partition (``AppendOnlyTopNFunction`` /
    ``StreamExecRank`` analog): keeps the best ``n`` rows per partition key,
    emits changelog rows (``+I`` entering, ``-D`` leaving) as ranks change;
    ``end_input`` emits the final ranked table (rank column included)."""

    def __init__(self, n: int, partition_column: Optional[str],
                 order_column: str, ascending: bool = False,
                 emit_changelog: bool = True, name: str = "top-n"):
        self.n = n
        self.partition_column = partition_column
        self.order_column = order_column
        self.ascending = ascending
        self.emit_changelog = emit_changelog
        self.name = name
        #: partition -> list of (sort_value, seq, row) kept sorted best-first
        self._tops: Dict[Any, List[Tuple[Any, int, dict]]] = {}
        self._seq = 0

    def _better(self, a, b) -> bool:
        return a < b if self.ascending else a > b

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        if len(batch) == 0:
            return []
        # vectorized pre-filter: rows strictly worse than a FULL partition's
        # current cutoff can never enter — drop them before the per-row
        # merge (the merge itself is inherently sequential: each admission
        # can change the cutoff)
        vals = np.asarray(batch.column(self.order_column))
        if self.partition_column is None:
            top = self._tops.get(None)
            if top is not None and len(top) >= self.n:
                thr = top[-1][0]
                keep = vals < thr if self.ascending else vals > thr
                if not keep.all():
                    batch = batch.select(keep)
                    if len(batch) == 0:
                        return []
        elif getattr(self, "_any_full", False):
            # only worth the per-row threshold lookup once SOME partition
            # filled up (before that the filter can never drop anything)
            parts_col = np.asarray(batch.column(self.partition_column))
            thr = np.asarray([
                (self._tops[p][-1][0]
                 if p in self._tops and len(self._tops[p]) >= self.n
                 else None)
                for p in parts_col.tolist()], object)
            has = np.asarray([t is not None for t in thr.tolist()])
            if has.any():
                tv = np.where(has, thr, vals[0]).astype(vals.dtype)
                keep = ~has | (vals < tv if self.ascending else vals > tv)
                if not keep.all():
                    batch = batch.select(keep)
                    if len(batch) == 0:
                        return []
        rows = batch.to_rows()
        out_rows: List[Dict[str, Any]] = []
        for row in rows:
            part = (row[self.partition_column]
                    if self.partition_column else None)
            top = self._tops.setdefault(part, [])
            val = row[self.order_column]
            self._seq += 1
            if len(top) < self.n or self._better(val, top[-1][0]):
                top.append((val, self._seq, row))
                top.sort(key=lambda e: (e[0], e[1]),
                         reverse=not self.ascending)
                if self.emit_changelog:
                    out_rows.append({"op": "+I", **row})
                if len(top) >= self.n:
                    self._any_full = True
                if len(top) > self.n:
                    _, _, evicted = top.pop()
                    if self.emit_changelog:
                        out_rows.append({"op": "-D", **evicted})
        if not out_rows or not self.emit_changelog:
            return []
        cols = {c: np.asarray([r.get(c) for r in out_rows])
                for c in out_rows[0]}
        return [RecordBatch(cols)]

    def end_input(self) -> List[StreamElement]:
        out_rows = []
        for part in sorted(self._tops, key=lambda p: (p is None, p)):
            for rank, (_v, _s, row) in enumerate(self._tops[part], start=1):
                out_rows.append({**row, "rank": rank, "op": "final"})
        if not out_rows:
            return []
        cols = {c: np.asarray([r.get(c) for r in out_rows])
                for c in out_rows[0]}
        return [RecordBatch(cols)]

    def snapshot_state(self) -> Dict[str, Any]:
        return {"tops": {k: list(v) for k, v in self._tops.items()},
                "seq": self._seq}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self._tops = {k: list(v) for k, v in snap.get("tops", {}).items()}
        self._seq = snap.get("seq", 0)


class DeduplicateOperator(StreamOperator):
    """Deduplication per key (``DeduplicateKeepFirstRow/KeepLastRow``):
    ``keep='first'`` emits a key's first row immediately and drops the rest;
    ``keep='last'`` retains the latest row per key and emits the final table
    at end-of-input (streaming updates would be a changelog; bounded gives
    batch semantics)."""

    def __init__(self, key_column: str, keep: str = "first",
                 order_column: Optional[str] = None, name: str = "deduplicate"):
        if keep not in ("first", "last"):
            raise ValueError("keep must be 'first' or 'last'")
        self.key_column = key_column
        self.keep = keep
        self.order_column = order_column
        self.name = name
        #: vectorized membership: key -> dense slot (insertion-ordered), the
        #: same probe the window state uses (state/keyindex) — no per-row
        #: Python dict lookups
        self._ki = None
        #: keep='last': columnar current-row store, one array per column,
        #: indexed by key slot; plus the per-slot order value
        self._cols: Dict[str, np.ndarray] = {}
        self._ordv: Optional[np.ndarray] = None

    def _slots(self, keys: np.ndarray) -> np.ndarray:
        from flink_tpu_torch.state.keyindex import KeyIndex, ObjectKeyIndex

        if self._ki is None:
            # dtype (not a sample element) decides: an object array of
            # tuples (composite DISTINCT keys) must use the object index
            self._ki = (KeyIndex() if keys.dtype.kind in "iu"
                        else ObjectKeyIndex())
        return self._ki.lookup_or_insert(keys)

    @staticmethod
    def _grow(arr: np.ndarray, n: int, fill) -> np.ndarray:
        if arr.shape[0] >= n:
            return arr
        out = np.full((max(n, arr.shape[0] * 2),) + arr.shape[1:], fill,
                      dtype=arr.dtype)
        out[: arr.shape[0]] = arr
        return out

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        if len(batch) == 0:
            return []
        keys = np.asarray(batch.column(self.key_column))
        prev_n = self._ki.num_keys if self._ki is not None else 0
        slots = self._slots(keys)
        if self.keep == "first":
            # first occurrence in-batch of a key unseen before this batch
            _, first_idx = np.unique(slots, return_index=True)
            mask = np.zeros(len(batch), bool)
            mask[first_idx] = True
            mask &= slots >= prev_n
            return [batch.select(mask)] if mask.any() else []
        # keep == 'last': per batch, the winning row per key is the max by
        # (order value, position); then compare against the retained order
        n = len(batch)
        if self.order_column is not None:
            ordv = np.asarray(batch.column(self.order_column))
        else:
            # arrival order must be GLOBAL across batches, not in-batch row
            # position — a later batch's row always beats an earlier one
            base = getattr(self, "_arrival", 0)
            ordv = base + np.arange(n)
            self._arrival = base + n
        # lexsort: last key per (slot, order, position) group wins
        order = np.lexsort((np.arange(n), ordv, slots))
        ss = slots[order]
        last_mask = np.r_[ss[1:] != ss[:-1], True]
        win = order[last_mask]                    # winning row index per slot
        wslots, word = slots[win], ordv[win]
        nk = self._ki.num_keys
        if self._ordv is None:
            self._ordv = np.full(max(nk, 64), None, object)
        self._ordv = self._grow(self._ordv, nk, None)
        cur = self._ordv[wslots]
        upd = np.asarray([c is None or o >= c
                          for o, c in zip(word.tolist(), cur.tolist())])
        if not upd.any():
            return []
        uw, uord = wslots[upd], word[upd]
        self._ordv[uw] = uord
        for c, v in batch.columns.items():
            arr = self._cols.get(c)
            if arr is None:
                arr = np.full(max(nk, 64), None, object)
            arr = self._grow(arr, nk, None)
            arr[uw] = np.asarray(v, object)[win[upd]]
            self._cols[c] = arr
        return []

    def end_input(self) -> List[StreamElement]:
        if self.keep == "first" or self._ki is None:
            return []
        n = self._ki.num_keys
        if n == 0 or not self._cols:
            return []

        def densify(a: np.ndarray) -> np.ndarray:
            # the store is object-dtype (mixed batches may differ); emit
            # with the natural inferred dtype so downstream device
            # consumers can jnp.asarray the column
            try:
                out = np.asarray(a.tolist())
            except (ValueError, TypeError):
                return a
            return a if out.dtype.kind == "O" and a.dtype.kind == "O" else out

        cols = {c: densify(arr[:n]) for c, arr in self._cols.items()}
        return [RecordBatch(cols)]

    def snapshot_state(self) -> Dict[str, Any]:
        snap: Dict[str, Any] = {}
        if self._ki is not None:
            snap["key_index"] = self._ki.snapshot()
            snap["key_index_kind"] = type(self._ki).__name__
            n = self._ki.num_keys
            # COPIES, not views: later batches mutate the store in place,
            # which must never reach into an already-taken checkpoint
            snap["cols"] = {c: np.asarray(a[:n]).copy()
                            for c, a in self._cols.items()}
            snap["ordv"] = (None if self._ordv is None
                            else np.asarray(self._ordv[:n]).copy())
            snap["arrival"] = getattr(self, "_arrival", 0)
        return snap

    def restore_state(self, snap: Dict[str, Any]) -> None:
        from flink_tpu_torch.state.keyindex import KeyIndex, ObjectKeyIndex

        if "seen" in snap:  # legacy dict snapshot
            seen = snap["seen"]
            if seen:
                keys = np.asarray(list(seen))
                self._slots(keys)
                rows = list(seen.values())
                if rows and rows[0]:
                    n = self._ki.num_keys
                    for c in rows[0]:
                        arr = np.full(max(n, 64), None, object)
                        arr[:n] = [r.get(c) for r in rows]
                        self._cols[c] = arr
                order = snap.get("order", {})
                self._ordv = np.full(max(len(seen), 64), None, object)
                for i, k in enumerate(seen):
                    self._ordv[i] = order.get(k)
            return
        if "key_index" not in snap:
            return
        cls = (ObjectKeyIndex if snap["key_index_kind"] == "ObjectKeyIndex"
               else KeyIndex)
        self._ki = cls.restore(snap["key_index"])
        self._cols = {c: np.asarray(a, object).copy()
                      for c, a in snap.get("cols", {}).items()}
        ov = snap.get("ordv")
        self._ordv = None if ov is None else np.asarray(ov, object).copy()
        self._arrival = snap.get("arrival", 0)


class SortLimitOperator(StreamOperator):
    """Bounded ORDER BY / LIMIT inside a query pipeline (subquery result
    semantics): buffer, sort at end of input, truncate."""

    def __init__(self, order_by: List[Tuple[str, bool]],
                 limit: Optional[int], name: str = "sort-limit"):
        self.order_by = list(order_by)
        self.limit = limit
        self.name = name
        self._buf: List[RecordBatch] = []

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        if len(batch):
            self._buf.append(batch)
        return []

    def end_input(self) -> List[StreamElement]:
        if not self._buf:
            return []
        b = RecordBatch.concat(self._buf)
        self._buf = []
        order = np.arange(len(b))
        for name, asc in reversed(self.order_by):
            col = np.asarray(b.column(name))[order]
            o = np.argsort(col, kind="stable")
            if not asc:
                o = o[::-1]
            order = order[o]
        if self.limit is not None:
            order = order[: self.limit]
        return [b.take(order)]

    def snapshot_state(self) -> Dict[str, Any]:
        if not self._buf:
            return {}
        b = RecordBatch.concat(self._buf)
        return {"cols": {k: np.asarray(v) for k, v in b.columns.items()},
                "ts": None if b.timestamps is None else np.asarray(b.timestamps)}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        if snap.get("cols"):
            self._buf = [RecordBatch(snap["cols"], timestamps=snap.get("ts"))]


class MiniBatchOperator(StreamOperator):
    """Bundle small batches into bigger ones before an expensive stateful
    operator (``MiniBatch`` bundle operators, ``operators/bundle/``):
    flushes at ``max_rows`` OR on any watermark/barrier boundary — control
    elements must never overtake their data."""

    is_stateless = True

    def __init__(self, max_rows: int = 16_384, name: str = "mini-batch"):
        self.max_rows = max_rows
        self.name = name
        self._buf: List[RecordBatch] = []
        self._rows = 0

    def _flush(self) -> List[StreamElement]:
        if not self._buf:
            return []
        out = [RecordBatch.concat(self._buf)] if len(self._buf) > 1 \
            else [self._buf[0]]
        self._buf = []
        self._rows = 0
        return out

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        if len(batch) == 0:
            return []
        self._buf.append(batch)
        self._rows += len(batch)
        if self._rows >= self.max_rows:
            return self._flush()
        return []

    def process_watermark(self, watermark: Watermark) -> List[StreamElement]:
        return self._flush()

    def end_input(self) -> List[StreamElement]:
        return self._flush()

    def snapshot_state(self) -> Dict[str, Any]:
        # barrier boundary: flush downstream is not possible from snapshot;
        # persist the bundle instead (reference finishes bundles pre-barrier)
        if not self._buf:
            return {}
        b = RecordBatch.concat(self._buf)
        return {"bundle": {k: np.asarray(v) for k, v in b.columns.items()},
                "ts": None if b.timestamps is None else np.asarray(b.timestamps)}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        if snap.get("bundle"):
            self._buf = [RecordBatch(snap["bundle"], timestamps=snap.get("ts"))]
            self._rows = sum(len(b) for b in self._buf)


class OverAggSpec:
    """One aggregate column of an OVER window (``StreamExecOverAggregate``).

    ``func``: SUM/COUNT/AVG/MIN/MAX/ROW_NUMBER; ``in_col``: pre-projected
    numeric input column (None for COUNT(*)/ROW_NUMBER).  Frame: both bounds
    None = unbounded preceding; ``rows`` = ROWS n PRECEDING AND CURRENT ROW;
    ``range_ms`` = RANGE INTERVAL n PRECEDING AND CURRENT ROW.  ``is_rows``
    picks per-row vs peer-inclusive semantics for unbounded frames
    (``RowTimeRowsUnboundedPrecedingFunction`` vs ``RowTimeRange...``)."""

    __slots__ = ("out_name", "func", "in_col", "rows", "range_ms", "is_rows",
                 "distinct")

    def __init__(self, out_name: str, func: str, in_col: Optional[str],
                 rows: Optional[int] = None, range_ms: Optional[int] = None,
                 is_rows: bool = False, distinct: bool = False):
        self.out_name = out_name
        self.func = func
        self.in_col = in_col
        self.rows = rows
        self.range_ms = range_ms
        self.is_rows = is_rows
        #: agg(DISTINCT x) over an UNBOUNDED frame: only each value's FIRST
        #: occurrence per partition contributes (SUM/COUNT/AVG); MIN/MAX are
        #: distinct-invariant
        self.distinct = distinct


def _sliding_window(padded: np.ndarray, width: int) -> np.ndarray:
    from numpy.lib.stride_tricks import sliding_window_view
    return sliding_window_view(padded, width)


class OverAggregateOperator(StreamOperator):
    """Per-partition running aggregates over time-ordered rows — the
    ``StreamExecOverAggregate`` analog (reference:
    ``flink-table-planner-blink/.../stream/StreamExecOverAggregate.java``,
    runtime ``RowTime{Range,Rows}{Unbounded,Bounded}PrecedingFunction``).

    Event-time mode buffers rows per partition and, on each watermark,
    emits every buffered row with ``ts <= watermark`` in timestamp order,
    each extended with its frame aggregates (vectorized: cumulative sums /
    sliding-window reductions over the sorted flush, not a per-row state
    probe).  Late rows (ts at or below the last watermark) are dropped, as
    in the reference.  Arrival mode (no time attribute) emits immediately
    in arrival order.
    """

    def __init__(self, specs: List[OverAggSpec],
                 partition_column: Optional[str],
                 event_time: bool = True, name: str = "sql-over-agg"):
        self.specs = specs
        self.partition_column = partition_column
        self.event_time = event_time
        self.name = name
        if not event_time and any(s.range_ms is not None for s in specs):
            raise ValueError("RANGE frames need an event-time ORDER BY")
        # per-partition-key state:
        self._pending: Dict[Any, List[RecordBatch]] = {}
        # spec index -> key -> running acc (unbounded) or None
        self._accs: List[Dict[Any, Any]] = [dict() for _ in specs]
        # spec index -> key -> (ts_buf, val_buf) tail kept for bounded frames
        self._tails: List[Dict[Any, Any]] = [dict() for _ in specs]
        # DISTINCT specs: spec index -> key -> set of values already seen
        # (the reference's distinct-state MapView)
        self._seen: List[Dict[Any, set]] = [dict() for _ in specs]
        self._last_wm = LONG_MIN
        self._dropped_late = 0

    # ------------------------------------------------------------- ingest
    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        if len(batch) == 0:
            return []
        if not self.event_time:
            return self._emit(batch, order=np.arange(len(batch)))
        ts = np.asarray(batch.timestamps)
        fresh = ts > self._last_wm
        if not fresh.all():
            self._dropped_late += int((~fresh).sum())
            batch = batch.select(fresh)
            if len(batch) == 0:
                return []
        if self.partition_column is None:
            self._pending.setdefault(None, []).append(batch)
            return []
        keys = np.asarray(batch.columns[self.partition_column])
        uniq, inv = np.unique(keys, return_inverse=True)
        for i, k in enumerate(uniq.tolist()):
            self._pending.setdefault(k, []).append(batch.select(inv == i))
        return []

    def process_watermark(self, watermark: Watermark) -> List[StreamElement]:
        out = self._flush(watermark.timestamp)
        self._last_wm = max(self._last_wm, watermark.timestamp)
        return out

    def end_input(self) -> List[StreamElement]:
        return self._flush(None)

    def _flush(self, up_to: Optional[int]) -> List[StreamElement]:
        out: List[StreamElement] = []
        for key in list(self._pending):
            merged = RecordBatch.concat(self._pending[key])
            ts = np.asarray(merged.timestamps)
            if up_to is None:
                ready, rest = merged, None
            else:
                mask = ts <= up_to
                if not mask.any():
                    continue
                ready = merged.select(mask)
                rest = merged.select(~mask) if not mask.all() else None
            if rest is not None and len(rest):
                self._pending[key] = [rest]
            else:
                del self._pending[key]
            order = np.argsort(np.asarray(ready.timestamps), kind="stable")
            out.extend(self._emit(ready, order, key=key))
        return out

    # ------------------------------------------------------------ compute
    def _emit(self, batch: RecordBatch, order: np.ndarray,
              key: Any = None) -> List[StreamElement]:
        batch = batch.take(order)
        m = len(batch)
        ts = (np.asarray(batch.timestamps) if batch.timestamps is not None
              else np.arange(m, dtype=np.int64))
        cols = dict(batch.columns)
        if not self.event_time and self.partition_column is not None:
            # arrival mode still aggregates per partition value
            keys = np.asarray(cols[self.partition_column])
            uniq, inv = np.unique(keys, return_inverse=True)
            if len(uniq) > 1:
                parts = [self._emit(batch.select(inv == i), np.arange(int((inv == i).sum())), key=k)
                         for i, k in enumerate(uniq.tolist())]
                return [RecordBatch.concat([p for part in parts for p in part])]
            key = uniq[0].item() if len(uniq) else None
        for i, spec in enumerate(self.specs):
            vals = (np.asarray(cols[spec.in_col], np.float64)
                    if spec.in_col is not None else np.ones(m, np.float64))
            if spec.func == "ROW_NUMBER":
                start = self._accs[i].get(key, 0)
                cols[spec.out_name] = start + np.arange(1, m + 1, dtype=np.int64)
                self._accs[i][key] = start + m
            elif spec.rows is not None:
                cols[spec.out_name] = self._rows_frame(i, spec, key, vals)
            elif spec.range_ms is not None:
                cols[spec.out_name] = self._range_frame(i, spec, key, ts, vals)
            else:
                first = (self._first_occurrence(i, key, vals)
                         if spec.distinct and spec.func not in ("MIN", "MAX")
                         else None)
                cols[spec.out_name] = self._unbounded(i, spec, key, ts, vals,
                                                      first)
        return [RecordBatch(cols, batch.timestamps, batch.key_ids,
                            batch.key_groups)]

    def _first_occurrence(self, i: int, key: Any,
                          vals: np.ndarray) -> np.ndarray:
        """bool mask: row carries the FIRST occurrence of its value in this
        partition (across flushes, via the per-spec seen set)."""
        seen = self._seen[i].setdefault(key, set())
        uniq, first_idx = np.unique(vals, return_index=True)
        novel = np.asarray([v not in seen for v in uniq.tolist()])
        seen.update(uniq[novel].tolist())
        mask = np.zeros(len(vals), bool)
        mask[first_idx[novel]] = True
        return mask

    def _unbounded(self, i: int, spec: OverAggSpec, key: Any, ts, vals,
                   first: Optional[np.ndarray] = None):
        """UNBOUNDED PRECEDING: running accumulator carried across flushes;
        RANGE flavor gives every peer group (equal ts) the group's total.
        ``first`` (DISTINCT): only first-occurrence rows contribute."""
        func = spec.func
        if func in ("SUM", "AVG", "COUNT"):
            if first is not None:
                vals = np.where(first, vals, 0.0)
            ps, pc = self._accs[i].get(key, (0.0, 0))
            cum_s = ps + np.cumsum(vals)
            cum_c = pc + (np.cumsum(first).astype(np.int64)
                          if first is not None
                          else np.arange(1, len(vals) + 1, dtype=np.int64))
            self._accs[i][key] = (float(cum_s[-1]), int(cum_c[-1]))
        elif func == "MIN":
            prev = self._accs[i].get(key, np.inf)
            cum_s = np.minimum.accumulate(np.minimum(vals, prev))
            self._accs[i][key] = float(cum_s[-1])
            cum_c = None
        elif func == "MAX":
            prev = self._accs[i].get(key, -np.inf)
            cum_s = np.maximum.accumulate(np.maximum(vals, prev))
            self._accs[i][key] = float(cum_s[-1])
            cum_c = None
        else:
            raise ValueError(f"unsupported OVER aggregate {func}")
        if not spec.is_rows and self.event_time:
            # peer-inclusive: each row reads the value at its LAST peer
            last_peer = np.searchsorted(ts, ts, side="right") - 1
            cum_s = cum_s[last_peer]
            if cum_c is not None:
                cum_c = cum_c[last_peer]
        if func == "COUNT":
            return cum_c.astype(np.int64)
        if func == "AVG":
            return cum_s / cum_c
        return cum_s

    def _rows_frame(self, i: int, spec: OverAggSpec, key: Any, vals):
        """ROWS n PRECEDING AND CURRENT ROW: NaN-padded sliding window over
        (kept tail ++ new rows); the tail keeps the last n values."""
        n = spec.rows
        tail = self._tails[i].get(key)
        prev = tail if tail is not None else np.empty(0, np.float64)
        allv = np.concatenate([prev, vals])
        # windows of width n+1 ending at each NEW row
        width = n + 1
        padded = np.concatenate([np.full(width - 1, np.nan), allv])
        win = _sliding_window(padded, width)[len(prev):]
        self._tails[i][key] = allv[-n:] if n > 0 else np.empty(0, np.float64)
        func = spec.func
        if spec.distinct and func in ("SUM", "COUNT", "AVG"):
            # per-frame dedup: sort each window row (NaN pads sort last),
            # NaN out equal neighbours — each distinct value counts once
            # INSIDE its frame, whatever its multiplicity
            sw = np.sort(win, axis=1)
            dup = np.zeros(sw.shape, bool)
            dup[:, 1:] = sw[:, 1:] == sw[:, :-1]
            win = np.where(dup, np.nan, sw)
        if func == "SUM":
            return np.nansum(win, axis=1)
        if func == "COUNT":
            return (~np.isnan(win)).sum(axis=1).astype(np.int64)
        if func == "AVG":
            return np.nansum(win, axis=1) / (~np.isnan(win)).sum(axis=1)
        if func == "MIN":
            return np.nanmin(win, axis=1)
        if func == "MAX":
            return np.nanmax(win, axis=1)
        raise ValueError(f"unsupported OVER aggregate {func}")

    def _range_frame(self, i: int, spec: OverAggSpec, key: Any, ts, vals):
        """RANGE r PRECEDING AND CURRENT ROW over event time, peer-inclusive;
        the tail keeps rows within r of the newest emitted timestamp."""
        r = spec.range_ms
        tail = self._tails[i].get(key)
        pts, pvs = tail if tail is not None else (np.empty(0, np.int64),
                                                 np.empty(0, np.float64))
        all_ts = np.concatenate([pts, np.asarray(ts, np.int64)])
        all_vs = np.concatenate([pvs, vals])
        lo = np.searchsorted(all_ts, np.asarray(ts, np.int64) - r, side="left")
        hi = np.searchsorted(all_ts, np.asarray(ts, np.int64), side="right")
        keep = all_ts > (all_ts[-1] - r if len(all_ts) else 0)
        self._tails[i][key] = (all_ts[keep], all_vs[keep])
        func = spec.func
        if spec.distinct and func in ("SUM", "AVG", "COUNT"):
            # variable-width frames: per-row distinct set (the per-frame
            # multiset, same per-row granularity as the MIN/MAX path below)
            s = np.empty(len(ts), np.float64)
            c = np.empty(len(ts), np.int64)
            for j in range(len(ts)):
                u = np.unique(all_vs[lo[j]:hi[j]])
                s[j] = u.sum()
                c[j] = u.size
            if func == "SUM":
                return s
            if func == "COUNT":
                return c
            return s / c
        if func in ("SUM", "AVG", "COUNT"):
            cum = np.concatenate([[0.0], np.cumsum(all_vs)])
            s = cum[hi] - cum[lo]
            c = (hi - lo).astype(np.int64)
            if func == "SUM":
                return s
            if func == "COUNT":
                return c
            return s / c
        red = np.minimum if func == "MIN" else np.maximum
        out = np.empty(len(ts), np.float64)
        for j in range(len(ts)):
            out[j] = red.reduce(all_vs[lo[j]:hi[j]])
        return out

    # ------------------------------------------------------------ snapshot
    def snapshot_state(self) -> Dict[str, Any]:
        def pack(batches):
            b = RecordBatch.concat(batches)
            return ({k: np.asarray(v) for k, v in b.columns.items()},
                    None if b.timestamps is None else np.asarray(b.timestamps))
        return {"pending": {k: pack(v) for k, v in self._pending.items()},
                "accs": [dict(d) for d in self._accs],
                "tails": [dict(d) for d in self._tails],
                "seen": [{k: sorted(s) for k, s in d.items()}
                         for d in self._seen],
                "last_wm": self._last_wm,
                "dropped_late": self._dropped_late}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self._pending = {k: [RecordBatch(cols, timestamps=ts)]
                         for k, (cols, ts) in snap.get("pending", {}).items()}
        self._accs = [dict(d) for d in snap.get(
            "accs", [dict() for _ in self.specs])]
        self._tails = [dict(d) for d in snap.get(
            "tails", [dict() for _ in self.specs])]
        self._seen = [{k: set(s) for k, s in d.items()}
                      for d in snap.get("seen",
                                        [dict() for _ in self.specs])]
        self._last_wm = snap.get("last_wm", LONG_MIN)
        self._dropped_late = snap.get("dropped_late", 0)


class HopWindowExpandOperator(StreamOperator):
    """Row → per-covering-HOP-window copies, for window-scoped dedup
    (DISTINCT aggregates in HOP windows).

    Each copy carries a synthetic timestamp ``t' = w*slide + size - 1``
    (its window's max timestamp) in a ``__hopts`` column AND as the batch
    timestamp, so a TUMBLE(slide) aggregation downstream buckets each copy
    into a bucket unique to its window: the bucket's end is ``>= t'``, so a
    REAL-time watermark never fires a window before its true close (at most
    ``slide-1`` ms after), and a copy whose real window already closed is
    late by exactly the reference's rule.  The real HOP bounds are
    recovered from the bucket start downstream
    (``w = bucket_start/slide - (size-1)//slide``)."""

    def __init__(self, size_ms: int, slide_ms: int,
                 time_col: str = "__hopts", name: str = "hop-expand"):
        self.size_ms = int(size_ms)
        self.slide_ms = int(slide_ms)
        self.time_col = time_col
        self.name = name

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        if len(batch) == 0:
            return []
        if batch.timestamps is None:
            raise ValueError("HOP expansion needs event-time timestamps")
        ts = np.asarray(batch.timestamps, np.int64)
        size, slide = self.size_ms, self.slide_ms
        max_covers = -(-size // slide)
        out: List[StreamElement] = []
        base_w = np.floor_divide(ts, slide)
        for k in range(max_covers):
            w = base_w - k
            valid = w * slide + size > ts
            if not valid.any():
                continue
            tprime = (w * slide + size - 1)[valid]
            cols = {c: np.asarray(v)[valid]
                    for c, v in batch.columns.items()}
            cols[self.time_col] = tprime
            out.append(RecordBatch(cols, timestamps=tprime))
        return out


class BranchMergeOperator(StreamOperator):
    """Streaming inner merge of two aggregate branches on a merge-key column
    — the glue for mixed DISTINCT/plain aggregate queries, where the planner
    splits one logical group-aggregate into a plain branch and a
    dedup-then-aggregate branch (the reference folds both into one
    ``AggsHandleFunction`` with distinct-state MapViews; here each branch
    stays a dense vectorized aggregate and the fired rows re-join).

    Both branches fire the same (key, window) set, so every buffered row
    pairs up exactly once; ``extra_cols`` names the columns only the right
    branch contributes.  Column data moves by vectorized fancy-indexing —
    the only per-row Python is a key-hash probe into the pending index."""

    is_two_input = True

    def __init__(self, merge_column: str, extra_cols: List[str],
                 name: str = "sql-branch-merge"):
        self.merge_column = merge_column
        self.extra_cols = extra_cols
        self.name = name
        #: per side: buffered batches with un-merged rows, and an index
        #: key -> (batch position in the buffer, row) of those rows
        self._bufs: Tuple[List[RecordBatch], List[RecordBatch]] = ([], [])
        self._unmatched: Tuple[Dict[Any, Tuple[int, int]],
                               Dict[Any, Tuple[int, int]]] = ({}, {})

    def process_batch2(self, batch: RecordBatch,
                       input_index: int) -> List[StreamElement]:
        if len(batch) == 0:
            return []
        s = input_index
        o = 1 - s
        keys = np.asarray(batch.columns[self.merge_column])
        other_idx = self._unmatched[o]
        mine_rows: List[int] = []              # rows of THIS batch that matched
        other_rows: List[Tuple[int, int]] = []  # (buf_i, row_i) on the other side
        buf_pos = len(self._bufs[s])
        mine_idx = self._unmatched[s]
        for i in range(len(keys)):
            hit = other_idx.pop(keys[i], None)
            if hit is None:
                mine_idx[keys[i]] = (buf_pos, i)
            else:
                mine_rows.append(i)
                other_rows.append(hit)
        if len(mine_rows) < len(keys):
            self._bufs[s].append(batch)
        if not mine_rows:
            return []

        # gather the other side's matched rows per buffered batch (vectorized)
        order = np.argsort([b * (1 << 32) + r for b, r in other_rows],
                           kind="stable")
        mine_sel = np.asarray(mine_rows, np.int64)[order]
        other_sorted = [other_rows[i] for i in order]
        other_parts: List[RecordBatch] = []
        mine_parts: List[np.ndarray] = []
        j = 0
        while j < len(other_sorted):
            bi = other_sorted[j][0]
            k = j
            while k < len(other_sorted) and other_sorted[k][0] == bi:
                k += 1
            rows = np.asarray([r for _, r in other_sorted[j:k]], np.int64)
            other_parts.append(self._bufs[o][bi].take(rows))
            mine_parts.append(mine_sel[j:k])
            j = k
        mine_take = batch.take(np.concatenate(mine_parts))
        other_take = RecordBatch.concat(other_parts)
        left, right = ((mine_take, other_take) if s == 0
                       else (other_take, mine_take))
        cols = dict(left.columns)
        for c in self.extra_cols:
            cols[c] = np.asarray(right.columns[c])
        if not other_idx and not mine_idx:
            # everything paired up — drop the consumed buffers
            self._bufs[0].clear()
            self._bufs[1].clear()
        return [RecordBatch(cols)]

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        return self.process_batch2(batch, 0)

    def _pack_pending(self, side: int) -> List[Dict[str, Any]]:
        rows = []
        for k, (bi, ri) in self._unmatched[side].items():
            b = self._bufs[side][bi]
            rows.append({n: np.asarray(v)[ri] for n, v in b.columns.items()})
        return rows

    def snapshot_state(self) -> Dict[str, Any]:
        # persist only un-merged rows, materialized (small residual set)
        return {"left_rows": self._pack_pending(0),
                "right_rows": self._pack_pending(1)}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self._bufs = ([], [])
        self._unmatched = ({}, {})
        for side, field in ((0, "left_rows"), (1, "right_rows")):
            rows = snap.get(field) or []
            if not rows:
                continue
            cols: Dict[str, np.ndarray] = {}
            for n in rows[0]:
                vals = [r[n] for r in rows]
                if any(isinstance(v, tuple) for v in vals):
                    # tuple cells (composite keys) must stay 1-D object
                    arr = np.empty(len(vals), object)
                    arr[:] = vals
                else:
                    arr = np.asarray(vals)
                cols[n] = arr
            b = RecordBatch(cols)
            self._bufs[side].append(b)
            keys = np.asarray(b.columns[self.merge_column])
            for i in range(len(b)):
                self._unmatched[side][keys[i]] = (0, i)

"""SQL runtime operators that reach the device: the joins and the changelog
group aggregate (port of the device half of
``flink_tpu/operators/sql_ops.py``).

Analogs of the blink table runtime (``flink-table-runtime-blink``):
``StreamExecJoin`` over bounded inputs (:class:`SqlJoinOperator`),
``StreamingJoinOperator`` (regular equi-join emitting a changelog) and
``GroupAggFunction`` with retraction (:class:`ChangelogGroupAggOperator`,
``+I/-U/+U/-D`` changelog rows).  The joins' equi-join core is
``operators/joins._join_pairs``: host numpy, or the device sorted-merge join
under ``FLINK_TPU_DEVICE_JOIN=1`` on the operator's ``device`` (resolved
when the device lane first runs).  The changelog aggregate keeps its
``[K]`` state on its device (the card unless ``device="cpu"``).

The rest of JAX's module (lookup and temporal joins, Top-N, deduplication,
sort-limit, mini-batch, over-aggregates, hop expansion, branch merge)
imports no JAX and comes with the port's runtime stack.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch import DeviceLike, resolve_device
from flink_tpu_torch.core.batch import RecordBatch, StreamElement
from flink_tpu_torch.operators.base import StreamOperator
from flink_tpu_torch.operators.joins import _join_pairs
from flink_tpu_torch.ops.scatter import (ordered_fold_counts_multi,
                                         total_order)
from flink_tpu_torch.ops.shapes import quantize_pow2
from flink_tpu_torch.state.keyindex import (key_index_kind, make_key_index,
                                            restore_key_index)


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

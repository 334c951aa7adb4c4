"""Keyed stream joins: interval join, window join, window co-group (port of
``flink_tpu/operators/joins.py``).

Analogs of ``IntervalJoinOperator`` (``flink-streaming-java/.../co/
IntervalJoinOperator.java``: per-key time-bucketed buffers, join on
|t_l - t_r| in [lower, upper], cleanup by watermark) and
``WindowedStream``-based joins (``JoinedStreams``/``CoGroupedStreams``:
both sides buffered per (key, window), joined at window fire).

Batched columnar design: each side's rows accumulate in per-side host
buffers (columns + timestamps + keys); on watermark advance the *completed*
time range is joined VECTORIZED — sort both sides by key, intersect key
spans, emit the per-key cross products filtered by the time predicate — one
numpy pass instead of per-record state lookups.

The equi-join of each fire is :func:`_join_pairs`: the numpy span
intersection by default, the device sorted-merge join
(``ops/join_kernels.device_join_pairs``) under ``FLINK_TPU_DEVICE_JOIN=1``,
read at each call as JAX reads it.  The device lane runs on the operator's
``device``, resolved when it first runs (``None``: the card, raising
without one); the host lane needs no device.  The two lanes give the same
pairs in another order: the host lane key-sorted, the device lane
left-major.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch import DeviceLike
from flink_tpu_torch.core.batch import (LONG_MIN, RecordBatch, StreamElement,
                                        Watermark)
from flink_tpu_torch.operators.base import StreamOperator
from flink_tpu_torch.windowing.assigners import WindowAssigner


class _SideBuffer:
    """Columnar row buffer for one join side."""

    def __init__(self):
        self.batches: List[RecordBatch] = []

    def add(self, batch: RecordBatch) -> None:
        if len(batch):
            self.batches.append(batch)

    def materialize(self) -> Optional[RecordBatch]:
        if not self.batches:
            return None
        out = RecordBatch.concat(self.batches)
        self.batches = [out]
        return out

    def retain_after(self, min_ts: int) -> None:
        """Drop rows with ts < min_ts (watermark cleanup)."""
        m = self.materialize()
        if m is None or m.timestamps is None:
            return
        keep = np.asarray(m.timestamps) >= min_ts
        self.batches = [m.select(keep)] if keep.any() else []

    def snapshot(self):
        m = self.materialize()
        return None if m is None else {
            "columns": {k: np.asarray(v) for k, v in m.columns.items()},
            "timestamps": None if m.timestamps is None else np.asarray(m.timestamps),
        }

    def restore(self, snap) -> None:
        self.batches = []
        if snap is not None:
            self.batches = [RecordBatch(snap["columns"],
                                        timestamps=snap["timestamps"])]


def _join_pairs(lk: np.ndarray, rk: np.ndarray,
                device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized equi-join index pairs: returns (left_idx, right_idx) of
    every cross pair with equal keys (sort + span intersection).

    Dispatches to the device sorted-merge join
    (``ops/join_kernels.device_join_pairs``, on ``device``) when
    ``FLINK_TPU_DEVICE_JOIN=1``; host-numpy span intersection otherwise."""
    import os

    if os.environ.get("FLINK_TPU_DEVICE_JOIN") == "1":
        from flink_tpu_torch.ops.join_kernels import device_join_pairs
        return device_join_pairs(lk, rk, device)
    lo = np.argsort(lk, kind="stable")
    ro = np.argsort(rk, kind="stable")
    lks, rks = lk[lo], rk[ro]
    # unique keys + spans on both sides
    lu, lstart, lcount = np.unique(lks, return_index=True, return_counts=True)
    ru, rstart, rcount = np.unique(rks, return_index=True, return_counts=True)
    common, li, ri = np.intersect1d(lu, ru, return_indices=True)
    if common.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ls, lc = lstart[li], lcount[li]
    rs, rc = rstart[ri], rcount[ri]
    n_pairs = int((lc * rc).sum())
    left_out = np.empty(n_pairs, np.int64)
    right_out = np.empty(n_pairs, np.int64)
    pos = 0
    for s_l, c_l, s_r, c_r in zip(ls.tolist(), lc.tolist(),
                                  rs.tolist(), rc.tolist()):
        block = c_l * c_r
        left_out[pos:pos + block] = np.repeat(lo[s_l:s_l + c_l], c_r)
        right_out[pos:pos + block] = np.tile(ro[s_r:s_r + c_r], c_l)
        pos += block
    return left_out, right_out


def _merge_columns(left: RecordBatch, right: RecordBatch,
                   li: np.ndarray, ri: np.ndarray,
                   left_prefix: str = "", right_prefix: str = "r_") -> Dict[str, np.ndarray]:
    cols: Dict[str, np.ndarray] = {}
    for k, v in left.columns.items():
        cols[left_prefix + k] = np.asarray(v)[li]
    for k, v in right.columns.items():
        name = right_prefix + k if (left_prefix + k) in cols or k in cols else k
        cols[name] = np.asarray(v)[ri]
    return cols


class IntervalJoinOperator(StreamOperator):
    """``a.interval_join(b).between(lower, upper)``: emit (l, r) where
    ``l.key == r.key`` and ``l.ts + lower <= r.ts <= l.ts + upper``."""

    is_two_input = True

    def __init__(self, key_column: str, other_key_column: str,
                 lower_ms: int, upper_ms: int,
                 output_fn: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None,
                 name: str = "interval-join", device: DeviceLike = None):
        self.device = device
        self.key_column = key_column
        self.other_key_column = other_key_column
        self.lower_ms = lower_ms
        self.upper_ms = upper_ms
        self.output_fn = output_fn
        self.name = name
        self.left = _SideBuffer()
        self.right = _SideBuffer()
        self._emitted_wm = LONG_MIN

    def process_batch2(self, batch: RecordBatch,
                       input_index: int) -> List[StreamElement]:
        if batch.timestamps is None:
            raise ValueError("interval join needs event-time timestamps")
        (self.left if input_index == 0 else self.right).add(batch)
        return []

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        return self.process_batch2(batch, 0)

    def process_watermark(self, watermark: Watermark) -> List[StreamElement]:
        return self._fire(watermark.timestamp)

    def end_input(self) -> List[StreamElement]:
        return self._fire(2 ** 62)

    def _fire(self, wm: int) -> List[StreamElement]:
        """Join all left rows whose FULL right-window [l+lower, l+upper] is
        covered by the watermark (they can never match again afterwards)."""
        l = self.left.materialize()
        r = self.right.materialize()
        out: List[StreamElement] = []
        if l is not None and r is not None and len(l) and len(r):
            lts = np.asarray(l.timestamps)
            complete = lts + self.upper_ms <= wm
            prev_done = lts + self.upper_ms <= self._emitted_wm
            ready = complete & ~prev_done
            if ready.any():
                lsel = l.select(ready)
                lk = np.asarray(lsel.column(self.key_column))
                rk = np.asarray(r.column(self.other_key_column))
                li, ri = _join_pairs(lk, rk, self.device)
                if li.size:
                    lt = np.asarray(lsel.timestamps)[li]
                    rt = np.asarray(r.timestamps)[ri]
                    ok = (rt >= lt + self.lower_ms) & (rt <= lt + self.upper_ms)
                    li, ri = li[ok], ri[ok]
                if li.size:
                    cols = _merge_columns(lsel, r, li, ri)
                    ts = np.maximum(np.asarray(lsel.timestamps)[li],
                                    np.asarray(r.timestamps)[ri])
                    if self.output_fn is not None:
                        cols = self.output_fn(cols)
                    out.append(RecordBatch(cols, timestamps=ts))
        self._emitted_wm = max(self._emitted_wm, wm)
        # cleanup: a LEFT row is dead once joined (ts+upper <= wm). A RIGHT
        # row may still match any UNFIRED left row; the oldest unfired left
        # row has ts > wm - upper, so right rows with ts >= wm - upper + lower
        # must be kept.
        self.left.retain_after(wm - self.upper_ms if wm < 2 ** 61 else 2 ** 62)
        self.right.retain_after(wm - self.upper_ms + self.lower_ms
                                if wm < 2 ** 61 else 2 ** 62)
        return out

    def snapshot_state(self) -> Dict[str, Any]:
        return {"left": self.left.snapshot(), "right": self.right.snapshot(),
                "emitted_wm": self._emitted_wm}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self.left.restore(snap.get("left"))
        self.right.restore(snap.get("right"))
        self._emitted_wm = snap.get("emitted_wm", LONG_MIN)


class WindowJoinOperator(StreamOperator):
    """``a.join(b).where(k).equal_to(k).window(w).apply(...)``: inner join of
    the two sides per (key, window), emitted at window fire.  ``cogroup=True``
    emits grouped rows to ``apply_fn(key, window, left_rows, right_rows)``
    instead (CoGroup semantics: fires even when one side is empty)."""

    is_two_input = True

    def __init__(self, assigner: WindowAssigner, key_column: str,
                 other_key_column: str,
                 apply_fn: Optional[Callable] = None,
                 cogroup: bool = False, name: str = "window-join",
                 device: DeviceLike = None):
        if getattr(assigner, "panes_per_window", 1) != 1:
            raise ValueError("window join supports tumbling windows "
                             "(one pane per window)")
        self.assigner = assigner
        self.key_column = key_column
        self.other_key_column = other_key_column
        self.apply_fn = apply_fn
        self.cogroup = cogroup
        self.name = name
        self.device = device
        self.left = _SideBuffer()
        self.right = _SideBuffer()
        self._fired_upto = LONG_MIN

    def process_batch2(self, batch: RecordBatch,
                       input_index: int) -> List[StreamElement]:
        if batch.timestamps is None:
            raise ValueError("window join needs event-time timestamps")
        (self.left if input_index == 0 else self.right).add(batch)
        return []

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        return self.process_batch2(batch, 0)

    def process_watermark(self, watermark: Watermark) -> List[StreamElement]:
        return self._fire(watermark.timestamp)

    def end_input(self) -> List[StreamElement]:
        return self._fire(2 ** 62)

    def _window_ids(self, ts: np.ndarray) -> np.ndarray:
        return self.assigner.pane_of(ts)

    def _fire(self, wm: int) -> List[StreamElement]:
        l = self.left.materialize()
        r = self.right.materialize()
        out: List[StreamElement] = []
        lw = self._window_ids(np.asarray(l.timestamps)) if l is not None and len(l) else np.zeros(0, np.int64)
        rw = self._window_ids(np.asarray(r.timestamps)) if r is not None and len(r) else np.zeros(0, np.int64)
        all_windows = np.union1d(np.unique(lw), np.unique(rw))
        for w in all_windows.tolist():
            bounds = self.assigner.window_bounds(int(w))
            if bounds.max_timestamp > wm or bounds.max_timestamp <= self._fired_upto:
                continue
            lsel = l.select(lw == w) if l is not None and len(l) else None
            rsel = r.select(rw == w) if r is not None and len(r) else None
            if self.cogroup:
                out.extend(self._emit_cogroup(int(w), bounds, lsel, rsel))
            else:
                if lsel is None or rsel is None or not len(lsel) or not len(rsel):
                    continue
                li, ri = _join_pairs(
                    np.asarray(lsel.column(self.key_column)),
                    np.asarray(rsel.column(self.other_key_column)),
                    self.device)
                if not li.size:
                    continue
                cols = _merge_columns(lsel, rsel, li, ri)
                cols["window_start"] = np.full(li.size, bounds.start, np.int64)
                cols["window_end"] = np.full(li.size, bounds.end, np.int64)
                if self.apply_fn is not None:
                    cols = self.apply_fn(cols)
                out.append(RecordBatch(
                    cols, timestamps=np.full(li.size, bounds.max_timestamp,
                                             np.int64)))
        self._fired_upto = max(self._fired_upto, wm)

        # drop rows of fully-fired windows (window end computed once per
        # UNIQUE window id, mapped back vectorized)
        def _ends(wids: np.ndarray) -> np.ndarray:
            uw, inv = np.unique(wids, return_inverse=True)
            uend = np.asarray([self.assigner.window_bounds(int(w)).max_timestamp
                               for w in uw.tolist()], np.int64)
            return uend[inv]

        if l is not None and len(l):
            ends = _ends(lw)
            self.left.batches = [l.select(ends > wm)] if (ends > wm).any() else []
        if r is not None and len(r):
            ends = _ends(rw)
            self.right.batches = [r.select(ends > wm)] if (ends > wm).any() else []
        return out

    def _emit_cogroup(self, w: int, bounds, lsel, rsel) -> List[StreamElement]:
        lkeys = (np.asarray(lsel.column(self.key_column))
                 if lsel is not None and len(lsel) else np.zeros(0, np.int64))
        rkeys = (np.asarray(rsel.column(self.other_key_column))
                 if rsel is not None and len(rsel) else np.zeros(0, np.int64))
        rows = []
        for key in np.union1d(np.unique(lkeys), np.unique(rkeys)).tolist():
            lrows = lsel.select(lkeys == key).to_rows() if lkeys.size else []
            rrows = rsel.select(rkeys == key).to_rows() if rkeys.size else []
            res = self.apply_fn(key, bounds, lrows, rrows)
            if res is not None:
                rows.append((res, bounds.max_timestamp))
        if not rows:
            return []
        cols = {k: np.asarray([r[0][k] for r in rows]) for k in rows[0][0]}
        return [RecordBatch(cols, timestamps=np.asarray([r[1] for r in rows],
                                                        np.int64))]

    def snapshot_state(self) -> Dict[str, Any]:
        return {"left": self.left.snapshot(), "right": self.right.snapshot(),
                "fired_upto": self._fired_upto}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self.left.restore(snap.get("left"))
        self.right.restore(snap.get("right"))
        self._fired_upto = snap.get("fired_upto", LONG_MIN)

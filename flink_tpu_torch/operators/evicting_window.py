"""Evicting window operator: raw-element window buffers + evictor + apply
(port of ``flink_tpu/operators/evicting_window.py``; the host lane of
``.evictor(...).apply(fn)``).

Analog of ``EvictingWindowOperator.java``: unlike the incremental
``WindowAggOperator`` (constant-size ACC per key x pane), evicting windows
must buffer the raw rows (reference: ``ListStateDescriptor`` in
``WindowOperatorBuilder:271``) because the evictor inspects individual
elements at fire time.

Layout (JAX's; the state stays on the host, where the fire-time compute,
the user's Python, runs):

- **Columnar pane buffers**: rows are appended as columnar chunks per PANE
  (the gcd-span shared by all covering windows) — sliding windows share
  pane buffers exactly like ``WindowAggOperator``'s pane ring shares ACC
  cells, so each row is stored once however many windows cover it.
- **Vectorized bookkeeping, per-key UDF boundary**: batching, the lateness
  gate (watermark formula, identical to ``WindowAggOperator``), pane
  retention and window-due computation are all array ops; only the
  evictor + ``apply_fn`` run per (key, window) — they are row-level user
  functions by contract (the reference's evictor inspects individual
  elements too, ``EvictingWindowOperator.java``), which is also why this
  state stays host-side: the fire-time compute IS the user's Python.
- **Key-group rescale**: snapshots are columnar with raw keys;
  ``split_snapshot``/``merge_snapshots`` route rows by key group
  (``StateAssignmentOperation.reDistributeKeyedStates`` analog) and
  parallel restores filter to the subtask's range — same story as
  sessions.  Under a mesh/multi-process deployment the keyed exchange
  partitions rows to subtasks; each subtask holds only its key range.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from flink_tpu_torch.core.batch import (LONG_MIN, RecordBatch, StreamElement,
                                        Watermark)
from flink_tpu_torch.operators.base import StreamOperator
from flink_tpu_torch.windowing.assigners import WindowAssigner
from flink_tpu_torch.windowing.evictors import Evictor


class EvictingWindowOperator(StreamOperator):
    """``window(...).evictor(...).apply(fn)``: fn(key, window, rows) -> row."""

    def __init__(self, assigner: WindowAssigner, evictor: Optional[Evictor],
                 key_column: str,
                 apply_fn: Callable[[Any, Any, List[dict]], Optional[dict]],
                 name: str = "evicting-window",
                 allowed_lateness_ms: int = 0):
        if not hasattr(assigner, "pane_of") or \
                not hasattr(assigner, "window_panes"):
            raise ValueError("evicting windows require a pane-based "
                             "assigner (tumbling/sliding)")
        self.assigner = assigner
        self.evictor = evictor
        self.key_column = key_column
        self.apply_fn = apply_fn
        self.name = name
        self.lateness = int(allowed_lateness_ms)
        #: pane id -> list of columnar chunks (seq[B], ts[B], cols dict)
        self._panes: Dict[int, List[tuple]] = {}
        self._seq = 0
        self.watermark: int = LONG_MIN
        self.last_fired_window: Optional[int] = None
        self.late_dropped = 0

    # ------------------------------------------------------------- ingest
    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        if batch.timestamps is None:
            raise ValueError("evicting windows need event-time timestamps")
        if len(batch) == 0:
            return []
        ts = np.asarray(batch.timestamps, np.int64)
        panes = self.assigner.pane_of(ts)

        # ---- beyond-lateness drop: cleanup time (last covering window end
        # - 1 + lateness) passed by the WATERMARK (never arrival order)
        if self.watermark != LONG_MIN:
            uniq_p = np.unique(panes)
            is_late = np.asarray(
                [self.assigner.last_window_end_of_pane(int(p)) - 1
                 + self.lateness <= self.watermark
                 for p in uniq_p.tolist()])
            if is_late.any():
                live = ~np.isin(panes, uniq_p[is_late])
                self.late_dropped += int(np.count_nonzero(~live))
                if not live.any():
                    return []
                batch = batch.select(live)
                ts = ts[live]
                panes = panes[live]

        cols = {c: np.asarray(v) for c, v in batch.columns.items()}
        refire: set = set()
        for p in np.unique(panes).tolist():
            m = panes == p
            nsel = int(np.count_nonzero(m))
            chunk = (np.arange(self._seq, self._seq + nsel, dtype=np.int64),
                     ts[m], {c: v[m] for c, v in cols.items()})
            self._seq += nsel
            self._panes.setdefault(int(p), []).append(chunk)
            # late-but-within-lateness rows re-fire already-fired windows —
            # but ONLY windows whose OWN cleanup horizon (maxTimestamp +
            # lateness) is still open: a sliding pane can outlive an early
            # covering window whose state the reference would have purged
            if self.last_fired_window is not None:
                w0, w1 = self.assigner.windows_of_pane(int(p))
                for w in range(w0, w1 + 1):
                    max_ts = self.assigner.window_bounds(w).max_timestamp
                    if (w <= self.last_fired_window
                            and max_ts <= self.watermark
                            and max_ts + self.lateness > self.watermark):
                        refire.add(w)
        if refire:
            return self._fire_windows(sorted(refire))
        return []

    # ------------------------------------------------------------- firing
    def process_watermark(self, watermark: Watermark) -> List[StreamElement]:
        self.watermark = max(self.watermark, watermark.timestamp)
        return self._advance(self.watermark)

    def end_input(self) -> List[StreamElement]:
        return self._advance(2 ** 62)

    def _largest_fired_window(self, now: int) -> Optional[int]:
        """Largest window id whose maxTimestamp <= now (the EventTimeTrigger
        fire horizon)."""
        a = self.assigner
        denom = a.pane_stride * a.pane_ms
        w = (now + 1 - a._offset - a.panes_per_window * a.pane_ms) // denom
        while a.window_bounds(w + 1).max_timestamp <= now:
            w += 1
        while a.window_bounds(w).max_timestamp > now:
            w -= 1
        return int(w)

    def _advance(self, now: int) -> List[StreamElement]:
        if not self._panes:
            return []
        a = self.assigner
        live = sorted(self._panes)
        lo_w = a.windows_of_pane(live[0])[0]
        hi_w = a.windows_of_pane(live[-1])[1]
        due = [w for w in range(
            max(lo_w, (self.last_fired_window + 1)
                if self.last_fired_window is not None else lo_w),
            hi_w + 1)
            if a.window_bounds(w).max_timestamp <= now]
        out = self._fire_windows(due)
        if due and (self.last_fired_window is None
                    or due[-1] > self.last_fired_window):
            self.last_fired_window = due[-1]
        # retention: drop panes past their cleanup horizon
        for p in live:
            if a.last_window_end_of_pane(p) - 1 + self.lateness <= now:
                del self._panes[p]
        return out

    def _fire_windows(self, windows) -> List[StreamElement]:
        out_rows, out_ts = [], []
        for w in windows:
            first, last = self.assigner.window_panes(w)
            chunks = [c for p in range(first, last + 1)
                      for c in self._panes.get(p, [])]
            if not chunks:
                continue
            bounds = self.assigner.window_bounds(w)
            seq = np.concatenate([c[0] for c in chunks])
            ts = np.concatenate([c[1] for c in chunks])
            cols = {name: np.concatenate([c[2][name] for c in chunks])
                    for name in chunks[0][2]}
            keys = cols[self.key_column]
            uniq, inv = np.unique(keys, return_inverse=True)
            order = np.lexsort((seq, inv))       # per-key, arrival order
            inv_s = inv[order]
            starts = np.flatnonzero(np.r_[True, inv_s[1:] != inv_s[:-1]])
            ends = np.r_[starts[1:], inv_s.size]
            for s, e in zip(starts, ends):
                sel = order[s:e]
                k = uniq[inv_s[s]]
                k = k.item() if isinstance(k, np.generic) else k
                rows = RecordBatch({c: v[sel] for c, v in
                                    cols.items()}).to_rows()
                if self.evictor is not None:
                    keep = self.evictor.keep_mask(ts[sel],
                                                  bounds.max_timestamp,
                                                  rows=rows)
                    rows = [r for r, m in zip(rows, keep) if m]
                if not rows:
                    continue
                res = self.apply_fn(k, bounds, rows)
                if res is not None:
                    out_rows.append(res)
                    out_ts.append(bounds.max_timestamp)
        if not out_rows:
            return []
        ocols = {c: np.asarray([r[c] for r in out_rows]) for c in out_rows[0]}
        return [RecordBatch(ocols, timestamps=np.asarray(out_ts, np.int64))]

    # ------------------------------------------------------- checkpointing
    def snapshot_state(self) -> Dict[str, Any]:
        packed = {}
        for p, chunks in self._panes.items():
            packed[p] = {
                "seq": np.concatenate([c[0] for c in chunks]),
                "ts": np.concatenate([c[1] for c in chunks]),
                "cols": {name: np.concatenate([c[2][name] for c in chunks])
                         for name in chunks[0][2]},
            }
        return {"panes": packed, "seq": self._seq,
                "watermark": self.watermark,
                "last_fired_window": self.last_fired_window,
                "late_dropped": self.late_dropped,
                "__key_column__": self.key_column}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        if "buffers" in snap:
            self._restore_legacy(snap)
            return
        self._seq = int(snap.get("seq", 0))
        self.watermark = int(snap.get("watermark", LONG_MIN))
        self.last_fired_window = snap.get("last_fired_window")
        self.late_dropped = int(snap.get("late_dropped", 0))
        self._panes = {}
        ctx = getattr(self, "ctx", None)
        for p, packed in snap.get("panes", {}).items():
            seq = np.asarray(packed["seq"])
            ts = np.asarray(packed["ts"])
            cols = {c: np.asarray(v) for c, v in packed["cols"].items()}
            if ctx is not None and ctx.parallelism > 1:
                from flink_tpu_torch.core import keygroups
                kg = keygroups.assign_to_key_group(
                    keygroups.hash_keys(cols[self.key_column]),
                    ctx.max_parallelism)
                rng = keygroups.compute_key_group_range(
                    ctx.max_parallelism, ctx.parallelism, ctx.subtask_index)
                keep = (kg >= rng.start) & (kg <= rng.end)
                seq, ts = seq[keep], ts[keep]
                cols = {c: v[keep] for c, v in cols.items()}
            if seq.size:
                self._panes[int(p)] = [(seq, ts, cols)]

    def _restore_legacy(self, snap: Dict[str, Any]) -> None:
        """Pre-r3 per-row dict snapshots ((key, window) -> [(seq, ts, row)]);
        tumbling assigners only (pane id == window id there)."""
        self._seq = int(snap["seq"])
        self.watermark = int(snap.get("fired_upto", LONG_MIN))
        # the old gate was fired_upto: every window whose maxTimestamp it
        # passed HAS fired — recover that horizon, or retained-for-lateness
        # windows would spuriously re-fire at the next watermark
        self.last_fired_window = (
            self._largest_fired_window(self.watermark)
            if self.watermark != LONG_MIN else None)
        self._panes = {}
        for (k, w), entries in snap.get("buffers", {}).items():
            for seq, ts, row in entries:
                chunk = (np.asarray([seq], np.int64),
                         np.asarray([ts], np.int64),
                         {c: np.asarray([v]) for c, v in row.items()})
                self._panes.setdefault(int(w), []).append(chunk)

    @staticmethod
    def split_snapshot(snap: Dict[str, Any], max_parallelism: int,
                       new_parallelism: int, key_column: str = None,
                       ) -> List[Dict[str, Any]]:
        """Rescale: route buffered rows by key group.  The key column name
        rides inside the snapshot's pane columns; the first column set's
        keys are found via ``__key_column__`` when present, else the caller
        passes it."""
        from flink_tpu_torch.core import keygroups
        kc = key_column or snap.get("__key_column__")
        out = []
        for i, rng in enumerate(
                keygroups.key_group_ranges(max_parallelism, new_parallelism)):
            part = dict(snap)
            part_panes = {}
            for p, packed in snap.get("panes", {}).items():
                keys = np.asarray(packed["cols"][kc])
                kg = keygroups.assign_to_key_group(
                    keygroups.hash_keys(keys), max_parallelism)
                keep = (kg >= rng.start) & (kg <= rng.end)
                if keep.any():
                    part_panes[p] = {
                        "seq": np.asarray(packed["seq"])[keep],
                        "ts": np.asarray(packed["ts"])[keep],
                        "cols": {c: np.asarray(v)[keep]
                                 for c, v in packed["cols"].items()},
                    }
            part["panes"] = part_panes
            if i > 0:
                part["late_dropped"] = 0
            out.append(part)
        return out

    @staticmethod
    def merge_snapshots(snaps: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Scale-down: per-pane columnar concat."""
        merged = dict(snaps[0])
        panes: Dict[int, Dict[str, Any]] = {}
        for s in snaps:
            for p, packed in s.get("panes", {}).items():
                cur = panes.get(p)
                if cur is None:
                    panes[p] = {k: (dict(v) if isinstance(v, dict) else
                                    np.asarray(v))
                                for k, v in packed.items()}
                else:
                    cur["seq"] = np.concatenate([cur["seq"], packed["seq"]])
                    cur["ts"] = np.concatenate([cur["ts"], packed["ts"]])
                    cur["cols"] = {c: np.concatenate([cur["cols"][c],
                                                      packed["cols"][c]])
                                   for c in cur["cols"]}
        merged["panes"] = panes
        merged["seq"] = max(int(s.get("seq", 0)) for s in snaps)
        merged["watermark"] = max(int(s.get("watermark", LONG_MIN))
                                  for s in snaps)
        merged["late_dropped"] = sum(int(s.get("late_dropped", 0))
                                     for s in snaps)
        lf = [s.get("last_fired_window") for s in snaps
              if s.get("last_fired_window") is not None]
        merged["last_fired_window"] = max(lf) if lf else None
        return merged

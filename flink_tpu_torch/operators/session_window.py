"""SessionWindowOperator: gap-based merging windows on keyed streams (port of
``flink_tpu/operators/session_window.py``).

Analog of the reference's merging-window path
(``WindowOperator.java:311-411`` + ``MergingWindowSet.java``): session
windows merge whenever their extended intervals overlap, and merging windows
merge their accumulators (``AggregateFunction.merge``).

The work splits as in JAX (SURVEY §7.3 "Sessions"):

- **Batch-local sessionization is vectorized**: sort rows by (key slot, ts),
  find gap boundaries with one array comparison, fold each batch-local
  session's values with ``ufunc.reduceat`` (declared kinds) or per-segment
  combines, no per-record Python.
- **Merge decisions stay on the host**: each batch-local session (not each
  record) merges into the per-key interval set, combining accumulator rows
  on overlap: the reference's ``MergingWindowSet`` with ``mergeNamespaces``
  replaced by a row-level combine.
- Accumulators live in dense ``[cap, *leaf]`` numpy row tables with a free
  list; fire-time ``get_result`` runs over every session firing at one
  watermark advance.

JAX's operator is host numpy too (``jax`` appears only in its tree maps), so
this one keeps its state on the host and needs no device; the mesh subclass
(``parallel/mesh_runtime.py`` ``MeshSessionWindowOperator``) moves the fold
to the card.  The host fold calls the same numpy functions on the same
arrays as JAX's, so its bits are JAX's.  The aggregate's ``lift``,
``combine_leaves`` and ``get_result`` take tensors in the port: the operator
converts at that boundary (:func:`_to_tensors`, :func:`_to_numpy`) and
keeps every dtype, so a merge of two f32 accumulators stays f32, and a
combine of an f32 accumulator with an f64 value widens as numpy's does.

Allowed lateness follows the reference: a fired session is retained until
``end + lateness`` passes the watermark; a late record inside that horizon
merges in and re-fires the (possibly larger) session; records beyond it are
dropped and counted, or shipped to ``late_output_tag`` as a
:class:`TaggedBatch`.  Processing-time sessions raise
``NotImplementedError``: the clock seam comes with the runtime-stack slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.core import keygroups
from flink_tpu_torch.core.batch import (LONG_MIN, RecordBatch, StreamElement,
                                        TaggedBatch, Watermark)
from flink_tpu_torch.core.functions import (SCATTER_UFUNCS, AggregateFunction,
                                            tree_leaves, tree_structure,
                                            tree_unflatten)
from flink_tpu_torch.operators.base import StreamOperator
from flink_tpu_torch.operators.window_agg import _PhaseTimer
from flink_tpu_torch.state.keyindex import NativeKeyIndex, make_key_index
from flink_tpu_torch.windowing.assigners import SessionGap

#: the refusal of processing-time sessions
PROCESSING_TIME = ("not in this slice of flink_tpu_torch: processing-time "
                   "sessions come with the runtime-stack slice (the clock "
                   "seam)")


def tree_map(fn: Callable, tree):
    """``fn`` over every leaf of a leaf-or-dict structure."""
    return tree_unflatten(tree_structure(tree),
                          [fn(l) for l in tree_leaves(tree)])


def _to_tensors(tree):
    """numpy leaves (arrays or scalars) -> CPU tensors of the same dtype, so
    the aggregate's tensor functions see JAX's operand dtypes.  Leaves
    torch cannot hold (strings, objects) stay numpy."""
    def conv(a):
        a = np.asarray(a)
        if a.dtype.kind not in "biuf":
            return a
        return torch.from_numpy(np.array(a))   # a copy: never aliases
    return tree_map(conv, tree)


def _to_numpy(tree):
    """Tensor leaves -> numpy arrays (a 0-d tensor -> a 0-d array)."""
    return tree_map(lambda t: t.cpu().numpy() if isinstance(t, torch.Tensor)
                    else np.asarray(t), tree)


def combine_rows(agg: AggregateFunction, a, b) -> Tuple[np.ndarray, ...]:
    """``agg.combine_leaves`` of two leaf tuples of numpy scalars or arrays,
    as numpy arrays of the dtypes the combine produced (JAX's host merge
    calls its combine on numpy scalars and keeps what comes out)."""
    out = agg.combine_leaves(tuple(_to_tensors(x) for x in a),
                             tuple(_to_tensors(x) for x in b))
    return tuple(_to_numpy(x) for x in out)


def host_result(agg: AggregateFunction, spec, leaves):
    """``agg.get_result`` over numpy accumulator leaves, as numpy."""
    return _to_numpy(agg.get_result(spec.unflatten(
        [_to_tensors(l) for l in leaves])))


class _SessionStore:
    """Dense session-row tables + per-key interval sets.

    Rows: key_slot/start/end/active/fired arrays + acc leaf tables.  The
    per-key dict maps key slot -> list of active row ids (usually length 1).
    """

    def __init__(self, spec):
        self.spec = spec
        self.key_slot = np.zeros(0, np.int64)
        self.start = np.zeros(0, np.int64)
        self.end = np.zeros(0, np.int64)      # exclusive: last_ts + gap
        self.active = np.zeros(0, bool)
        self.fired = np.zeros(0, bool)        # fired but retained (lateness)
        self.leaves = [np.zeros((0,) + s, d)
                       for s, d in zip(spec.leaf_shapes, spec.leaf_dtypes)]
        #: row -> distinct-value set (DISTINCT aggregates only; the
        #: reference's distinct-state MapView per window namespace)
        self.sets: List[Optional[set]] = []
        self.by_key: Dict[int, List[int]] = {}
        self._free: List[int] = []

    def _grow(self, extra: int) -> None:
        old = self.key_slot.size
        cap = max(old + extra, max(64, old * 2))

        def gr(a, fill=0):
            n = np.full((cap,) + a.shape[1:], fill, a.dtype)
            n[:old] = a
            return n
        self.key_slot, self.start, self.end = (gr(self.key_slot),
                                               gr(self.start), gr(self.end))
        self.active, self.fired = gr(self.active, False), gr(self.fired,
                                                             False)
        self.leaves = [gr(l) for l in self.leaves]
        for i, init in enumerate(self.spec.leaf_inits):
            self.leaves[i][old:] = init
        self.sets.extend([None] * (cap - old))
        self._free.extend(range(cap - 1, old - 1, -1))

    def alloc(self) -> int:
        if not self._free:
            self._grow(1)
        return self._free.pop()

    def release(self, row: int) -> None:
        self.active[row] = False
        self.fired[row] = False
        for leaf, init in zip(self.leaves, self.spec.leaf_inits):
            leaf[row] = init
        self.sets[row] = None
        self._free.append(row)

    def acc_of(self, row: int) -> Tuple[np.ndarray, ...]:
        return tuple(leaf[row] for leaf in self.leaves)

    def set_acc(self, row: int, acc) -> None:
        for leaf, a in zip(self.leaves, acc):
            leaf[row] = a


class SessionWindowOperator(StreamOperator):
    """``key_by(k).window(EventTimeSessionWindows(gap)).aggregate(agg)``."""

    def __init__(self, session: SessionGap, agg: AggregateFunction,
                 key_column: str,
                 value_selector: Optional[Callable] = None,
                 value_column: Optional[str] = None,
                 allowed_lateness_ms: int = 0,
                 output_column: str = "result",
                 emit_window_bounds: bool = True,
                 name: str = "session-window-agg",
                 late_output_tag: Optional[str] = None,
                 distinct_specs: Optional[Dict[str, str]] = None,
                 distinct_column: Optional[str] = None):
        if not session.is_event_time:
            raise NotImplementedError(PROCESSING_TIME)
        #: sideOutputLateData: beyond-lateness records ship as TaggedBatch
        #: instead of dropping (the drop counter stays untouched for them)
        self.gap = int(session.gap_ms)
        self.is_event_time = True
        self.agg = agg
        self.key_column = key_column
        if value_selector is not None:
            self._select = value_selector
        elif value_column is not None:
            self._select = lambda cols: cols[value_column]
        else:
            self._select = lambda cols: cols
        self.lateness = int(allowed_lateness_ms)
        self.output_column = output_column
        self.emit_window_bounds = emit_window_bounds
        self.name = name
        self.spec = agg.acc_spec()
        self.kinds = agg.scatter_kind_leaves()
        self.key_index: Optional[NativeKeyIndex] = None
        self.store = _SessionStore(self.spec)
        self.late_output_tag = late_output_tag
        #: DISTINCT aggregates over merging windows: per-session value SETS
        #: ride the interval merge — out_name -> func (COUNT/SUM/AVG/MIN/
        #: MAX) over ``distinct_column``
        self.distinct_specs = distinct_specs or {}
        self.distinct_column = distinct_column
        if self.distinct_specs and distinct_column is None:
            raise ValueError("distinct_specs needs distinct_column")
        self.watermark: int = LONG_MIN
        self.late_dropped: int = 0
        #: host wall ns per phase: ``probe`` (the key index), ``fold`` (the
        #: batch's sessionization and fold; the mesh's exchange and device
        #: fold inside it), ``merge`` (the interval-set merge), ``fire``
        self.phase_ns: Dict[str, int] = {}
        #: bytes moved to (``h2d``) and from (``d2h``) a device
        self.phase_bytes: Dict[str, int] = {}

    # ------------------------------------------------------------ ingest
    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        late_out: List[StreamElement] = []
        keys = np.asarray(batch.column(self.key_column))
        if batch.timestamps is None:
            raise ValueError(
                "session windows need event timestamps "
                "(assign_timestamps_and_watermarks upstream)")
        ts = np.asarray(batch.timestamps, np.int64)
        with _PhaseTimer(self.phase_ns, "probe"):
            if self.key_index is None:
                self.key_index = make_key_index(keys[0])
            slots = self.key_index.lookup_or_insert(keys).astype(np.int64)
        values = self._select(batch.columns)

        # ---- beyond-lateness drop, evaluated on the POST-MERGE window like
        # the reference (isWindowLate after mergeWindows): a candidate-late
        # record survives if it overlaps a still-retained session, because
        # the merged window then inherits that session's cleanup time.
        if self.watermark != LONG_MIN:
            late = (ts + self.gap + self.lateness) <= self.watermark
            if late.any():
                for i in np.nonzero(late)[0]:
                    t0, t1 = int(ts[i]), int(ts[i]) + self.gap
                    for r in self.store.by_key.get(int(slots[i]), ()):
                        if self.store.start[r] < t1 and t0 < self.store.end[r]:
                            late[i] = False
                            break
                if late.any() and self.late_output_tag is not None:
                    late_out.append(TaggedBatch(self.late_output_tag,
                                                batch.select(late)))
                elif late.any():
                    self.late_dropped += int(late.sum())
                keep = ~late
                slots, ts = slots[keep], ts[keep]
                values = tree_map(lambda c: np.asarray(c)[keep], values)
                if not slots.size:
                    return late_out

        # ---- vectorized batch-local sessionization + fold (the mesh
        # subclass reroutes the FOLD through the device exchange)
        with _PhaseTimer(self.phase_ns, "fold"):
            bounds = (self._session_bounds(slots, ts)
                      if self.distinct_specs else None)
            b_key, b_start, b_end, accs = self._sessionize(slots, ts, values,
                                                           bounds)
            bsets = (self._batch_distinct_sets(values, bounds)
                     if self.distinct_specs else None)
        with _PhaseTimer(self.phase_ns, "merge"):
            return late_out + self._merge(b_key, b_start, b_end, accs, bsets)

    def _merge(self, b_key, b_start, b_end, accs, bsets
               ) -> List[StreamElement]:
        """Host merge of the batch's sessions into the per-key interval
        sets; returns the late re-fires."""
        n_sess = b_key.size
        st = self.store
        refire: set = set()  # rows needing an immediate late re-fire
        for i in range(n_sess):
            k = int(b_key[i])
            start, end = int(b_start[i]), int(b_end[i])
            acc = tuple(a[i] for a in accs)
            dset = set(bsets[i]) if bsets is not None else None
            rows = st.by_key.get(k)
            if rows is None:
                rows = []
                st.by_key[k] = rows
            absorbed_fired = False
            survivors = []
            for r in rows:
                # overlap of [start,end) with stored [st.start[r], st.end[r])
                if st.start[r] < end and start < st.end[r]:
                    acc = combine_rows(self.agg, st.acc_of(r), acc)
                    if dset is not None and st.sets[r]:
                        dset |= st.sets[r]
                    start = min(start, int(st.start[r]))
                    end = max(end, int(st.end[r]))
                    # merging a fired (or refire-pending) session: re-fire
                    absorbed_fired |= bool(st.fired[r]) or (r in refire)
                    refire.discard(r)
                    st.release(r)
                else:
                    survivors.append(r)
            row = st.alloc()
            st.key_slot[row], st.start[row], st.end[row] = k, start, end
            st.active[row] = True
            st.fired[row] = False
            st.set_acc(row, acc)
            st.sets[row] = dset
            survivors.append(row)
            st.by_key[k] = survivors
            if absorbed_fired and end <= self.watermark:
                refire.add(row)

        out: List[StreamElement] = []
        if refire:
            rows = np.asarray(sorted(refire), np.int64)
            out.extend(self._emit_rows(rows))
            st.fired[rows] = True  # re-fired: don't emit again next advance
        return out

    # ------------------------------------------------- batch sessionization
    def _session_bounds(self, slots: np.ndarray, ts: np.ndarray):
        """Sort by (key slot, ts) and find batch-local session boundaries:
        a new session starts on key change or when the next record's window
        [t, t+gap) does NOT overlap the previous one's — records exactly
        ``gap`` apart stay separate, the boundary of the interval-overlap
        merge and of the reference's ``TimeWindow.intersects``.  Returns
        (order, s_slots, s_ts, sess_id, firsts, lasts)."""
        order = np.lexsort((ts, slots))
        s_slots, s_ts = slots[order], ts[order]
        new_key = np.concatenate([[True], s_slots[1:] != s_slots[:-1]])
        gap_break = np.concatenate([[True],
                                    (s_ts[1:] - s_ts[:-1]) >= self.gap])
        sess_first = new_key | gap_break
        sess_id = np.cumsum(sess_first) - 1          # batch-local session id
        firsts = np.nonzero(sess_first)[0]
        lasts = np.concatenate([firsts[1:] - 1, [len(s_ts) - 1]])
        return order, s_slots, s_ts, sess_id, firsts, lasts

    def _sessionize(self, slots: np.ndarray, ts: np.ndarray, values,
                    bounds=None):
        """(b_key, b_start, b_end, acc leaf list) for this batch's local
        sessions — host fold (``ufunc.reduceat`` over the sorted runs for
        declared kinds, per-segment combine otherwise).  ``bounds``: the
        precomputed ``_session_bounds`` result."""
        order, s_slots, s_ts, sess_id, firsts, lasts = \
            bounds if bounds is not None else self._session_bounds(slots, ts)
        lifted = tree_leaves(_to_numpy(self.agg.lift(_to_tensors(values))))
        lifted = [np.asarray(l)[order] for l in lifted]
        n_sess = int(firsts.size)
        b_key = s_slots[firsts]
        b_start = s_ts[firsts]
        b_end = s_ts[lasts] + self.gap               # exclusive end

        accs = [np.empty((n_sess,) + sh, dt) for sh, dt in
                zip(self.spec.leaf_shapes, self.spec.leaf_dtypes)]
        for a, init in zip(accs, self.spec.leaf_inits):
            a[:] = init
        if self.kinds is not None:
            # rows are session-contiguous after the sort: one reduceat per
            # leaf folds every session
            for a, l, kind in zip(accs, lifted, self.kinds):
                a[:] = SCATTER_UFUNCS[kind].reduceat(
                    l.astype(a.dtype, copy=False), firsts, axis=0)
        else:
            for i, b in enumerate(firsts):
                e = int(lasts[i]) + 1
                acc = tuple(a[i] for a in accs)
                for j in range(b, e):
                    acc = combine_rows(self.agg, acc,
                                       tuple(l[j] for l in lifted))
                for a, v in zip(accs, acc):
                    a[i] = v
        return b_key, b_start, b_end, accs

    def _batch_distinct_sets(self, values, bounds) -> List[set]:
        """Per batch-local session: the SET of distinct-column values
        (``bounds`` = the shared ``_session_bounds`` result)."""
        order, _ss, _st, _sid, firsts, lasts = bounds
        dv = np.asarray(values[self.distinct_column])[order]
        return [set(dv[f:l + 1].tolist()) for f, l in zip(firsts, lasts)]

    # ------------------------------------------------------------- firing
    def process_watermark(self, watermark: Watermark) -> List[StreamElement]:
        self.watermark = watermark.timestamp
        with _PhaseTimer(self.phase_ns, "fire"):
            return self._fire_due(self.watermark)

    def end_input(self) -> List[StreamElement]:
        return []  # MAX_WATERMARK already fired everything

    def _fire_due(self, t: int) -> List[StreamElement]:
        st = self.store
        due = st.active & ~st.fired & (st.end <= t)
        out = (self._emit_rows(np.nonzero(due)[0]) if due.any() else [])
        st.fired[due] = True
        # cleanup past the lateness horizon (clearAllState analog)
        dead = st.active & st.fired & (st.end + self.lateness <= t)
        for r in np.nonzero(dead)[0]:
            k = int(st.key_slot[r])
            rows = st.by_key.get(k)
            if rows is not None:
                rows = [x for x in rows if x != r]
                if rows:
                    st.by_key[k] = rows
                else:
                    del st.by_key[k]
            st.release(int(r))
        return out

    def _emit_rows(self, rows: np.ndarray) -> List[StreamElement]:
        if rows.size == 0:
            return []
        st = self.store
        order = np.argsort(st.end[rows], kind="stable")
        rows = rows[order]
        result = host_result(self.agg, self.spec,
                             [leaf[rows] for leaf in st.leaves])
        raw_keys = np.asarray(self.key_index.reverse_keys())[st.key_slot[rows]]
        cols: Dict[str, Any] = {self.key_column: raw_keys}
        if isinstance(result, dict):
            cols.update({k: np.asarray(v) for k, v in result.items()})
        else:
            cols[self.output_column] = np.asarray(result)
        for out, func in self.distinct_specs.items():
            vals = []
            for r in rows.tolist():
                s = st.sets[r] or ()
                if func == "COUNT":
                    vals.append(len(s))
                elif func == "SUM":
                    vals.append(float(sum(s)))
                elif func == "AVG":
                    vals.append(float(sum(s)) / len(s) if s else 0.0)
                elif func == "MIN":
                    vals.append(min(s) if s else np.nan)
                else:
                    vals.append(max(s) if s else np.nan)
            cols[out] = np.asarray(vals)
        if self.emit_window_bounds:
            cols["window_start"] = st.start[rows].copy()
            cols["window_end"] = st.end[rows].copy()
        # emission timestamp = window end - 1 (reference: maxTimestamp)
        return [RecordBatch(cols, timestamps=st.end[rows] - 1)]

    # -------------------------------------------------------- checkpointing
    def snapshot_state(self) -> Dict[str, Any]:
        st = self.store
        live = np.nonzero(st.active)[0]
        raw = (np.asarray(self.key_index.reverse_keys())[st.key_slot[live]]
               if self.key_index is not None else np.zeros(0, np.int64))
        snap = {
            "session_keys": raw,                  # raw keys: rescale-safe
            "start": st.start[live].copy(),
            "end": st.end[live].copy(),
            "fired": st.fired[live].copy(),
            "acc": tuple(leaf[live].copy() for leaf in st.leaves),
            "watermark": self.watermark,
            "late_dropped": self.late_dropped,
        }
        if self.distinct_specs:
            snap["sets"] = [sorted(st.sets[r]) if st.sets[r] else []
                            for r in live.tolist()]
        return snap

    def restore_state(self, snap: Dict[str, Any]) -> None:
        keys = np.asarray(snap["session_keys"])
        self.watermark = int(snap.get("watermark", LONG_MIN))
        self.late_dropped = int(snap.get("late_dropped", 0))
        self.key_index = None
        self.store = _SessionStore(self.spec)
        if keys.size == 0:
            return
        ctx = getattr(self, "ctx", None)
        keep = np.ones(keys.size, bool)
        if ctx is not None and ctx.parallelism > 1:
            kg = keygroups.assign_to_key_group(keygroups.hash_keys(keys),
                                               ctx.max_parallelism)
            rng = keygroups.compute_key_group_range(
                ctx.max_parallelism, ctx.parallelism, ctx.subtask_index)
            keep = (kg >= rng.start) & (kg <= rng.end)
        sel = np.nonzero(keep)[0]
        keys = keys[sel]
        if keys.size == 0:
            return
        starts = np.asarray(snap["start"])[sel]
        ends = np.asarray(snap["end"])[sel]
        fireds = np.asarray(snap["fired"])[sel]
        accs = tuple(np.asarray(a)[sel] for a in snap["acc"])
        sets = ([snap["sets"][i] for i in sel.tolist()]
                if "sets" in snap else None)
        self.key_index = make_key_index(keys[0])
        slots = self.key_index.lookup_or_insert(keys).astype(np.int64)
        st = self.store
        for i in range(keys.size):
            row = st.alloc()
            st.key_slot[row] = slots[i]
            st.start[row], st.end[row] = starts[i], ends[i]
            st.fired[row] = fireds[i]
            st.active[row] = True
            st.set_acc(row, tuple(a[i] for a in accs))
            if sets is not None:
                st.sets[row] = set(sets[i]) if sets[i] else None
            st.by_key.setdefault(int(slots[i]), []).append(row)

    @staticmethod
    def merge_snapshots(snaps: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Scale-down: sessions are plain per-row records — concatenate."""
        live = [s for s in snaps if "session_keys" in s
                and len(np.asarray(s["session_keys"]))]
        if not live:
            return dict(snaps[0]) if snaps else {}
        merged = dict(live[0])
        merged["session_keys"] = np.concatenate(
            [np.asarray(s["session_keys"]) for s in live])
        for f in ("start", "end", "fired"):
            merged[f] = np.concatenate([np.asarray(s[f]) for s in live])
        merged["acc"] = tuple(
            np.concatenate([np.asarray(s["acc"][i]) for s in live])
            for i in range(len(live[0]["acc"])))
        if any("sets" in s for s in live):
            merged["sets"] = [x for s in live
                              for x in s.get(
                                  "sets",
                                  [[]] * len(np.asarray(s["session_keys"])))]
        # MIN, not max: under an unaligned rescale cut the parts sit at
        # different watermarks, and the behind part's in-flight elements
        # replay with their own watermark progression — a max here would
        # mark them late on arrival.  The ahead part's fired sessions keep
        # their fired flags, so the lower restart point cannot double-fire.
        merged["watermark"] = min(int(s.get("watermark", LONG_MIN))
                                  for s in live)
        merged["late_dropped"] = sum(int(s.get("late_dropped", 0))
                                     for s in live)
        return merged

    @staticmethod
    def split_snapshot(snap: Dict[str, Any], max_parallelism: int,
                       new_parallelism: int) -> List[Dict[str, Any]]:
        """Rescale: route session rows by their key's key group."""
        keys = np.asarray(snap["session_keys"])
        kg = (keygroups.assign_to_key_group(keygroups.hash_keys(keys),
                                            max_parallelism)
              if keys.size else np.zeros(0, np.int64))
        out = []
        for i, rng in enumerate(
                keygroups.key_group_ranges(max_parallelism, new_parallelism)):
            sel = (kg >= rng.start) & (kg <= rng.end)
            sub = dict(snap)
            sub["session_keys"] = keys[sel]
            for f in ("start", "end", "fired"):
                sub[f] = np.asarray(snap[f])[sel]
            sub["acc"] = tuple(np.asarray(a)[sel] for a in snap["acc"])
            if "sets" in snap:
                sub["sets"] = [snap["sets"][j]
                               for j in np.nonzero(sel)[0].tolist()]
            if i > 0:
                # job-level counter: carried by part 0 only, or a later
                # merge_snapshots would sum it new_parallelism times
                sub["late_dropped"] = 0
            out.append(sub)
        return out

"""Device fast lane for evicting windows: columnar raw elements on the card
(port of ``flink_tpu/operators/evicting_device.py``).

``EvictingWindowOperator`` (the general lane) buffers rows on the host,
because the evictor and the apply function are arbitrary per-row Python.
The common evictor cases need no row-level Python: ``CountEvictor`` keeps
the last n per (key, window) and ``TimeEvictor`` a trailing time span, both
masks, and the built-in aggregates (sum/min/max/count/avg) are segment
combines.  This operator keeps the raw elements as COLUMNAR DEVICE BUFFERS,
evicts by mask in one fire step, combines on the device, and downloads only
the fired per-key results: the batched analog of
``EvictingWindowOperator.java:1`` with ``CountEvictor``/``TimeEvictor``.

Layout: ONE append-only element buffer (values f32 ``[C]``, key slots,
pane ids and timestamps int32 ``[C]``, a host write cursor).  Arrival order
is buffer order (what ``CountEvictor`` ranks by).  Panes and timestamps are
int32 relative to epochs fixed at the first batch (``_pane_epoch``,
``_ts_epoch``, as JAX's x64-off columns); snapshots store absolute values.
The steps, JAX's jitted steps as torch ops on the operator's device:

- ``_append_step``: the pow2-padded batch written as one slice at the
  cursor, under the watchdog (``runtime/device_health.guarded_dispatch``,
  label ``{name}.append_step``, compile grace on a new ``(C, Bp)``
  geometry).  The write happens inside the guarded thunk, behind the
  previous append's CUDA event (the fence), into the buffers of the epoch
  it was dispatched in.  A wedge quarantines the tier and FAILS the
  operator: raw-element buffers have no host twin to degrade onto, so the
  restart path recovers from the last checkpoint, as in JAX.  JAX's
  ``dynamic_update_slice`` would clamp a start that does not fit; the port
  raises instead (``_ensure`` makes it fit).
- ``_compact_step``: a stable partition of the live rows (pane >= the
  retention floor) to the front when the buffer would overflow, one scalar
  download (the live count).  The buffer then doubles if it must.
- ``_fire_step``: the window's rows, a stable sort by key (arrival order
  within a key), ``torch.cummax`` for each group's start (JAX's
  ``associative_scan(max)``), the counts, the ``CountEvictor`` rank mask or
  the ``TimeEvictor`` span from each key's newest timestamp, and the
  segment fold of the kept rows.  ``add`` leaves and the kept counts fold
  through ``ops/scatter.py`` ``ordered_fold_counts`` (the hand-written
  ``scatter_fold`` kernel on the card), which adds each key's rows in
  arrival order, the order JAX's CPU ``segment_sum`` adds them in;
  ``min``/``max`` leaves through ``scatter_reduce_``.  ``get_result`` runs
  on the device; the mask and the results for ``ka`` keys come down.

Scope, as JAX's: pane-based assigners, event time, Count/Time evictors,
aggregates with declared scatter kinds; anything else raises JAX's
``ValueError``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from flink_tpu_torch import DeviceLike, resolve_device
from flink_tpu_torch.core.batch import (LONG_MIN, RecordBatch, StreamElement,
                                        Watermark)
from flink_tpu_torch.core.functions import (AggregateFunction, RuntimeContext,
                                            tree_leaves, tree_unflatten,
                                            tree_structure)
from flink_tpu_torch.operators.base import StreamOperator
from flink_tpu_torch.operators.window_agg import _PhaseTimer
from flink_tpu_torch.ops.scatter import _identity_fill, ordered_fold_counts
from flink_tpu_torch.ops.shapes import next_pow2 as _next_pow2
from flink_tpu_torch.runtime import device_health
from flink_tpu_torch.runtime.device_health import DeviceQuarantinedError
from flink_tpu_torch.state.keyindex import (NativeKeyIndex, make_key_index,
                                            restore_key_index)
from flink_tpu_torch.windowing.assigners import WindowAssigner
from flink_tpu_torch.windowing.evictors import (CountEvictor, Evictor,
                                                TimeEvictor)


def device_evictor_supported(evictor: Optional[Evictor],
                             agg: AggregateFunction) -> bool:
    """True when the (evictor, aggregate) pair runs on the device lane."""
    return (isinstance(evictor, (CountEvictor, TimeEvictor))
            and agg.scatter_kind_leaves() is not None)


class DeviceEvictingWindowOperator(StreamOperator):
    """``window(...).evictor(Count/Time).aggregate(built-in)``, on the
    device (the card unless ``device="cpu"`` is asked for)."""

    INVALID_PANE = -(1 << 31)     # int32 min: invalid row

    def __init__(self, assigner: WindowAssigner, evictor: Evictor,
                 agg: AggregateFunction, key_column: str,
                 value_column: str, output_column: str = "result",
                 allowed_lateness_ms: int = 0,
                 emit_window_bounds: bool = True,
                 initial_capacity: int = 1 << 12,
                 initial_key_capacity: int = 1 << 10,
                 name: str = "evicting-window-device",
                 device: DeviceLike = None):
        if not hasattr(assigner, "pane_of"):
            raise ValueError("device evictor lane requires a pane-based "
                             "assigner (tumbling/sliding)")
        if not isinstance(evictor, (CountEvictor, TimeEvictor)):
            raise ValueError("device evictor lane supports CountEvictor and "
                             "TimeEvictor")
        kinds = agg.scatter_kind_leaves()
        if kinds is None:
            raise ValueError("device evictor lane requires an aggregate "
                             "with declared scatter kinds (built-ins)")
        self.device = resolve_device(device)
        self.assigner = assigner
        self.evictor = evictor
        self.agg = agg
        self.kinds = kinds
        self.spec = agg.acc_spec()
        self.key_column = key_column
        self.value_column = value_column
        self.output_column = output_column
        self.emit_window_bounds = emit_window_bounds
        self.lateness = int(allowed_lateness_ms)
        self.name = name
        self._C = _next_pow2(initial_capacity)
        self._K = _next_pow2(initial_key_capacity)
        self.key_index: Optional[NativeKeyIndex] = None
        self._vals = None          # f32 [C]
        self._keys = None          # i32 [C]  (K = invalid row)
        self._panes = None         # i32 [C], RELATIVE to _pane_epoch
        self._ts = None            # i32 [C], RELATIVE to _ts_epoch (ms)
        self._count = 0            # host write cursor (rows appended)
        self._pane_epoch: Optional[int] = None
        self._ts_epoch: Optional[int] = None
        self.pane_base: Optional[int] = None
        self.max_pane: Optional[int] = None
        self.last_fired_window: Optional[int] = None
        self.watermark: int = LONG_MIN
        self.late_dropped = 0
        #: the previous append's CUDA event (None on the CPU)
        self._fence = None
        #: bumped by every restore: an abandoned append of an earlier epoch
        #: never writes
        self._epoch = 0
        self._last_dispatch_geom = None
        #: host wall ns per phase: ``probe`` (the key index),
        #: ``device_dispatch`` (the guarded append, uploads included),
        #: ``compact``, ``fire`` (every fire step and its download),
        #: ``snapshot``
        self.phase_ns: Dict[str, int] = {}
        #: ``h2d`` (appends), ``d2h`` (fires and compactions),
        #: ``d2h_snapshot`` (the columns a snapshot reads)
        self.phase_bytes: Dict[str, int] = {}
        #: fire steps run (each folds through one ordered fold)
        self.fire_steps = 0

    def open(self, ctx: RuntimeContext) -> None:
        pass

    @property
    def buffer_bytes(self) -> int:
        """Bytes of the element buffer on the device (four 4-byte
        columns)."""
        return 0 if self._vals is None else 16 * int(self._vals.shape[0])

    def _on_card(self):
        return (torch.cuda.device(self.device)
                if self.device.type == "cuda" else contextlib.nullcontext())

    def _d2h(self, nbytes: int, key: str = "d2h") -> None:
        self.phase_bytes[key] = self.phase_bytes.get(key, 0) + nbytes

    # -------------------------------------------------------------- buffers
    def _alloc(self, C: int):
        dev = self.device
        return (torch.zeros(C, dtype=torch.float32, device=dev),
                torch.full((C,), self._K, dtype=torch.int32, device=dev),
                torch.full((C,), self.INVALID_PANE, dtype=torch.int32,
                           device=dev),
                torch.zeros(C, dtype=torch.int32, device=dev))

    def _ensure(self, extra: int):
        if self._vals is None:
            while self._C < extra:
                self._C <<= 1
            self._vals, self._keys, self._panes, self._ts = \
                self._alloc(self._C)
            return
        if self._count + extra <= self._C:
            return
        # try a compaction of expired panes first
        if self.pane_base is not None:
            with _PhaseTimer(self.phase_ns, "compact"):
                self._compact()
        while self._count + extra > self._C:
            self._C <<= 1
            grown = self._alloc(self._C)
            half = self._C >> 1
            for new, old in zip(grown, (self._vals, self._keys, self._panes,
                                        self._ts)):
                new[:half] = old
            self._vals, self._keys, self._panes, self._ts = grown

    def _compact_step(self, vals, keys, panes, ts, lo: int):
        """Stable-partition live rows (pane >= lo) to the front, reset the
        rest to invalid; returns the new columns and the live count (a
        device scalar).  JAX sorts ``~live`` stably; the port sorts it as
        int8 (a bool sort is not stable everywhere)."""
        live = panes >= lo
        order = torch.sort((~live).to(torch.int8), stable=True).indices
        n_live = live.sum()
        keep = torch.arange(vals.shape[0], device=vals.device) < n_live
        vals2 = torch.where(keep, vals[order], 0.0)
        keys2 = torch.where(keep, keys[order], self._K)
        panes2 = torch.where(keep, panes[order], self.INVALID_PANE)
        ts2 = torch.where(keep, ts[order], 0)
        return vals2, keys2, panes2, ts2, n_live

    def _compact(self):
        lo = self.pane_base - (self._pane_epoch or 0)
        with self._on_card():
            self._vals, self._keys, self._panes, self._ts, n_live = \
                self._compact_step(self._vals, self._keys, self._panes,
                                   self._ts, lo)
            self._count = int(n_live)  # one scalar download
        self._d2h(8)

    def _append_step(self, bufs, uploads, at: int) -> None:
        """Write the padded batch ``uploads`` into ``bufs`` at row ``at``,
        in place.  Raises where JAX's ``dynamic_update_slice`` would clamp
        the start (the batch does not fit)."""
        n = int(uploads[0].shape[0])
        if at < 0 or at + n > int(bufs[0].shape[0]):
            raise ValueError(f"append of {n} rows at {at} does not fit a "
                             f"buffer of {int(bufs[0].shape[0])} rows")
        for buf, up in zip(bufs, uploads):
            buf[at:at + n] = up

    def _upload(self, arrays):
        return [torch.from_numpy(a).to(self.device) for a in arrays]

    # ------------------------------------------------------------ batching
    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        if len(batch) == 0:
            return []
        keys = np.asarray(batch.column(self.key_column))
        if self.key_index is None:
            self.key_index = make_key_index(keys[0] if keys.ndim else keys,
                                            capacity_hint=self._K)
        if batch.timestamps is None:
            raise ValueError("evicting windows require timestamps")
        ts = np.asarray(batch.timestamps, np.int64)
        panes = self.assigner.pane_of(ts)
        # lateness gate (same formula as WindowAggOperator)
        if self.watermark != LONG_MIN:
            p0, p1 = int(panes.min()), int(panes.max())
            cand = (np.arange(p0, p1 + 1, dtype=np.int64)
                    if p1 - p0 < 64 else np.unique(panes))
            is_late = np.asarray(
                [self.assigner.last_window_end_of_pane(int(p)) - 1
                 + self.lateness <= self.watermark for p in cand.tolist()])
            if is_late.any():
                live = ~np.isin(panes, cand[is_late])
                self.late_dropped += int(np.count_nonzero(~live))
                if not live.any():
                    return []
                batch = batch.select(live)
                keys = np.asarray(batch.column(self.key_column))
                ts = ts[live]
                panes = panes[live]
        with _PhaseTimer(self.phase_ns, "probe"):
            slots = self.key_index.lookup_or_insert(keys)
        if self.key_index.num_keys > self._K:
            self._grow_keys()
        pmin, pmax = int(panes.min()), int(panes.max())
        self.pane_base = pmin if self.pane_base is None \
            else min(self.pane_base, pmin)
        self.max_pane = pmax if self.max_pane is None \
            else max(self.max_pane, pmax)
        B = len(batch)
        Bp = _next_pow2(B, 64)
        self._ensure(Bp)
        if self._pane_epoch is None:
            self._pane_epoch = pmin
            self._ts_epoch = int(ts.min())
        vals = np.zeros(Bp, np.float32)
        vals[:B] = np.asarray(batch.column(self.value_column), np.float32)
        kp = np.full(Bp, self._K, np.int32)
        kp[:B] = slots
        pp = np.full(Bp, self.INVALID_PANE, np.int32)
        pp[:B] = panes - self._pane_epoch
        tp = np.zeros(Bp, np.int32)
        tp[:B] = ts - self._ts_epoch
        with _PhaseTimer(self.phase_ns, "device_dispatch"):
            self._guarded_append((vals, kp, pp, tp))
        self._count += Bp
        return []

    def _guarded_append(self, host) -> None:
        """The append under the watchdog.  The thunk waits on the previous
        append's fence, checks the epoch, uploads and writes into the
        buffers captured here (so an abandoned attempt that wakes after a
        restore writes nothing into the restored state), and records the
        new fence."""
        bufs = (self._vals, self._keys, self._panes, self._ts)
        at, epoch, Bp = self._count, self._epoch, int(host[0].shape[0])
        geom = (int(bufs[0].shape[0]), Bp)
        fresh_geom = geom != self._last_dispatch_geom
        self._last_dispatch_geom = geom
        nbytes = sum(a.nbytes for a in host)

        def thunk():
            with self._on_card():
                if self._fence is not None:
                    self._fence.synchronize()
                uploads = self._upload(host)
                if epoch != self._epoch:
                    raise DeviceQuarantinedError(
                        f"{self.name}.append_step: superseded by a restore")
                self._append_step(bufs, uploads, at)
                if self.device.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record()
                    self._fence = ev

        device_health.guarded_dispatch(
            thunk, mb=nbytes / 1e6, label=f"{self.name}.append_step",
            compile_grace=fresh_geom)
        self.phase_bytes["h2d"] = self.phase_bytes.get("h2d", 0) + nbytes

    def _grow_keys(self):
        # key ids only live in the buffer's key column; capacity is virtual
        while self._K < self.key_index.num_keys:
            self._K <<= 1

    # ---------------------------------------------------------------- time
    def process_watermark(self, watermark: Watermark) -> List[StreamElement]:
        self.watermark = max(self.watermark, watermark.timestamp)
        with _PhaseTimer(self.phase_ns, "fire"):
            return self._advance(self.watermark)

    def end_input(self) -> List[StreamElement]:
        with _PhaseTimer(self.phase_ns, "fire"):
            return self._advance(2 ** 62)

    def _advance(self, now: int) -> List[StreamElement]:
        if self._vals is None or self.pane_base is None:
            return []
        a = self.assigner
        lo_w = a.windows_of_pane(self.pane_base)[0]
        hi_w = a.windows_of_pane(self.max_pane)[1]
        start = (self.last_fired_window + 1
                 if self.last_fired_window is not None else lo_w)
        out: List[StreamElement] = []
        fired_any = None
        for w in range(max(start, lo_w), hi_w + 1):
            if a.window_bounds(w).max_timestamp > now:
                break
            out.extend(self._fire_window(w))
            fired_any = w
        if fired_any is not None and (self.last_fired_window is None
                                      or fired_any > self.last_fired_window):
            self.last_fired_window = fired_any
        # retention: panes behind every un-expired window drop at compaction
        p = self.pane_base
        while (p <= self.max_pane
               and a.last_window_end_of_pane(p) - 1 + self.lateness <= now):
            p += 1
        self.pane_base = p
        return out

    # --------------------------------------------------------------- fires
    def _fire_step(self, vals, keys, panes, ts, k_active: int, n_rows: int,
                   lo: int, hi: int):
        """Evict + combine for one window (relative panes ``[lo, hi]``) on
        the device, over the first ``n_rows`` buffer rows (a pow2 bound on
        the cursor) and key slots below ``k_active``; returns the ``[K]``
        kept mask and the results."""
        vals, keys = vals[:n_rows], keys[:n_rows]
        panes, ts = panes[:n_rows], ts[:n_rows]
        K = k_active
        dev = vals.device
        in_win = (panes >= lo) & (panes <= hi) & (keys < K)
        kmask = torch.where(in_win, keys, K)
        # group by key, arrival order preserved within groups
        order = torch.sort(kmask, stable=True).indices
        sk = kmask[order]
        sv = vals[order]
        st = ts[order]
        idx = torch.arange(sk.shape[0], device=dev)
        is_start = torch.ones(sk.shape[0], dtype=torch.bool, device=dev)
        is_start[1:] = sk[1:] != sk[:-1]
        group_start = torch.cummax(torch.where(is_start, idx, 0), 0).values
        pos = idx - group_start
        sk_l = sk.to(torch.int64)
        counts = torch.zeros(K + 1, dtype=torch.int32, device=dev)
        counts.index_add_(0, kmask.to(torch.int64), in_win.to(torch.int32))
        gsize = counts[sk_l]
        valid = sk < K
        if isinstance(self.evictor, CountEvictor):
            keep = valid & ((gsize - pos) <= self.evictor.n)
        else:  # TimeEvictor: trailing span from each key's newest element
            tmax = torch.full((K + 1,), torch.iinfo(torch.int32).min,
                              dtype=torch.int32, device=dev)
            tmax.scatter_reduce_(
                0, kmask.to(torch.int64),
                torch.where(in_win, ts, -(1 << 31) + 1), reduce="amax",
                include_self=True)
            keep = valid & (st >= tmax[sk_l] - self.evictor.window_ms)
        lifted = [l.contiguous() for l in tree_leaves(self.agg.lift(sv))]
        # evicted rows fold into segment K, which the fold drops
        seg_ids = torch.where(keep, sk, K).contiguous()
        # each segment starts from its kind's identity: 0 for add, +-inf
        # (the int bounds for ints) for min/max
        planes = [torch.full((K,), _identity_fill(kind, l.dtype),
                             dtype=l.dtype, device=dev)
                  for l, kind in zip(lifted, self.kinds)]
        kept_counts = torch.zeros(K, dtype=torch.int32, device=dev)
        ordered_fold_counts(planes, kept_counts, seg_ids, lifted, self.kinds)
        result = self.agg.get_result(self.spec.unflatten(planes))
        return kept_counts > 0, result

    def _fire_window(self, w: int) -> List[StreamElement]:
        if self.key_index is None or self._vals is None:
            return []
        first, last = self.assigner.window_panes(w)
        if last < self.pane_base or first > self.max_pane:
            return []
        ka = _next_pow2(max(self.key_index.num_keys, 1), 64)
        nrows = _next_pow2(max(self._count, 1), 64)
        ep = self._pane_epoch or 0
        with self._on_card():
            mask, result = self._fire_step(
                self._vals, self._keys, self._panes, self._ts, ka,
                min(nrows, self._C), first - ep, last - ep)
            self.fire_steps += 1
            mask_np = mask.cpu().numpy()
            res_np = tree_unflatten(tree_structure(result),
                                    [r.cpu().numpy()
                                     for r in tree_leaves(result)])
        self._d2h(mask_np.nbytes + sum(r.nbytes for r in tree_leaves(res_np)))
        idx = np.flatnonzero(mask_np[: self.key_index.num_keys])
        if idx.size == 0:
            return []
        res_np = tree_unflatten(tree_structure(res_np),
                                [r[idx] for r in tree_leaves(res_np)])
        win = self.assigner.window_bounds(w)
        keys = np.asarray(self.key_index.reverse_keys())[idx]
        cols: Dict[str, Any] = {self.key_column: keys}
        if isinstance(res_np, dict):
            cols.update(res_np)
        else:
            cols[self.output_column] = res_np
        if self.emit_window_bounds:
            cols["window_start"] = np.broadcast_to(np.int64(win.start),
                                                   (idx.size,))
            cols["window_end"] = np.broadcast_to(np.int64(win.end),
                                                 (idx.size,))
        ts = np.broadcast_to(np.int64(win.max_timestamp), (idx.size,))
        return [RecordBatch(cols, timestamps=ts)]

    # ----------------------------------------------------------- snapshots
    def snapshot_state(self) -> Dict[str, Any]:
        with _PhaseTimer(self.phase_ns, "snapshot"):
            return self._snapshot()

    def _snapshot(self) -> Dict[str, Any]:
        snap: Dict[str, Any] = {
            "pane_base": self.pane_base, "max_pane": self.max_pane,
            "last_fired_window": self.last_fired_window,
            "watermark": self.watermark, "late_dropped": self.late_dropped,
        }
        if self.key_index is not None:
            snap["key_index"] = self.key_index.snapshot()
            snap["key_index_kind"] = "KeyIndex"
        if self._vals is not None and self._count:
            n = self._count
            ep = self._pane_epoch or 0
            te = self._ts_epoch or 0
            with self._on_card():
                cols = [c[:n].cpu().numpy() for c in (
                    self._vals, self._keys, self._panes, self._ts)]
            self._d2h(sum(c.nbytes for c in cols), "d2h_snapshot")
            rel_panes = cols[2]
            panes = rel_panes.astype(np.int64) + ep
            lo = (self.pane_base if self.pane_base is not None
                  else self.INVALID_PANE + 1 + ep)
            live = (rel_panes != self.INVALID_PANE) & (panes >= lo)
            # boolean indexing copies: nothing aliases the live buffers
            snap["vals"] = cols[0][live]
            snap["keys"] = cols[1][live]
            snap["panes"] = panes[live]
            snap["ts"] = (cols[3].astype(np.int64) + te)[live]
        return snap

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self._epoch += 1
        self._fence = None
        self.pane_base = snap["pane_base"]
        self.max_pane = snap["max_pane"]
        self.last_fired_window = snap["last_fired_window"]
        self.watermark = snap["watermark"]
        self.late_dropped = snap.get("late_dropped", 0)
        self._vals = None
        self._count = 0
        if "key_index" in snap:
            self.key_index = restore_key_index(snap["key_index"],
                                               snap["key_index_kind"])
            self._grow_keys()
        self._pane_epoch = None
        self._ts_epoch = None
        if "vals" in snap and len(snap["vals"]):
            n = len(snap["vals"])
            self._pane_epoch = int(np.min(snap["panes"]))
            self._ts_epoch = int(np.min(snap["ts"]))
            Bp = _next_pow2(n, 64)
            self._ensure(Bp)
            vals = np.zeros(Bp, np.float32)
            vals[:n] = snap["vals"]
            kp = np.full(Bp, self._K, np.int32)
            kp[:n] = snap["keys"]
            pp = np.full(Bp, self.INVALID_PANE, np.int32)
            pp[:n] = np.asarray(snap["panes"]) - self._pane_epoch
            tp = np.zeros(Bp, np.int32)
            tp[:n] = np.asarray(snap["ts"]) - self._ts_epoch
            with self._on_card():
                self._append_step(
                    (self._vals, self._keys, self._panes, self._ts),
                    self._upload((vals, kp, pp, tp)), 0)
            self._count = Bp   # the padded length, as JAX's restore keeps

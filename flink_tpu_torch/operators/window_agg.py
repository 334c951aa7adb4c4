"""WindowAggOperator — keyed windowed aggregation on dense device state
(port of ``flink_tpu/operators/window_agg.py``, main path).

The slice carried here is the one the repo is built around: a keyed,
event-time, tumbling windowed aggregate with

- **the host emit tier**: a write-through host VALUE mirror of the
  accumulator cells (f64/i64) serves fires and snapshots with no
  device->host traffic beyond the probe lane's delta pulls.  With
  ``native_emit=True`` (the JAX operator's default) the mirror and the key
  index are the port's C host layer (``csrc/host_mirror.cc``: the keydict
  and ``WinMirror``, ``state/native_mirror.py``): one C pass per block of
  rows inserts keys, folds the mirror and, under scatter sync, writes the
  device scatter ids, and a fire is one C sweep.  ``native_shards=N``
  splits that pass over N host threads, bit-identical at any N.  Without
  it, the numpy ``KeyIndex`` and a numpy mirror;
- **two sync cadences** for the device replica, a ``[K, P]`` pane ring per
  accumulator leaf plus an int32 ``[K, P]`` count (K = key capacity, P = pane
  ring).  ``device_sync="scatter"``: every micro-batch also folds into the
  replica, so it stays equal to the mirror.  ``device_sync="deferred"``: the
  mirror is the authority and the replica is stale between sync points;
  :meth:`device_refresh` rebuilds it from the mirror (:meth:`verify_mirror`
  refreshes first);
- **the device key probe** (``device_probe="on"``): warm keys resolve on the
  card (``state/device_keyindex.py``, kernel ``csrc/probe.cu``, which takes
  the int64 keys and hashes them itself), their rows
  fold into a device DELTA ring in the mirror's dtypes (f64 values, int32
  counts), and under scatter sync into the replica too; the host pass
  touches only the compact miss list.  The mirror catches up pane by pane
  when a pane is read (fire, snapshot).  ``device_probe="off"`` is the plain
  lane: host key lookup, then (scatter sync) one device fold per batch,
  ``csrc/scatter_fold.cu``'s ordered fold on the card;
- **the fused super-batch lane** (``superbatch=N > 1``,
  ``operators/fused_step.py``): batches park until N are staged, a fire
  boundary passes, or any state read calls :meth:`flush_pipeline`; then all
  of them advance in one pass.  With the probe on that pass is ONE device
  step over the concatenated rows, and under deferred sync ONE
  ``probe_fold`` launch (``csrc/probe_fold.cu``) probes them and folds the
  warm rows into the delta ring in row order;
- **the device emit tier** (``emit_tier="device"``, with
  ``snapshot_source="device"``): there is no value mirror.  Every batch's
  keys resolve on the host through the key index (``native_emit=True``: the
  C keydict, with no ``WinMirror`` bound), every batch folds into the
  ``[K, P]`` replica through the ordered fold, and a boolean host emit
  mirror records which (key, pane) cells hold data.  A fire gathers exactly
  those key rows' window panes on the card, combines them in JAX's pairwise
  order and applies ``get_result``, and downloads only the result values; a
  snapshot downloads the live panes, and a restore uploads them and rebuilds
  the emit mirror from the counts.  With ``async_fire=True`` a fire's
  download is started and its rows surface from a later call
  (:meth:`drain_pending_fires`).  The device probe is inactive on this tier,
  as in JAX; the fused lane concatenates the staged batches into one fold.

Where JAX donated buffers to a jitted step, this port updates the same
tensors in place.  Batches are not padded: torch needs no static shapes, so
a step sees exactly the batch's rows, and the miss list is one
``torch.nonzero`` — the step's only host sync.  JAX's scoped ``enable_x64``
goes away: torch keeps f64 and i64 on the card.  The sync cadence and the
super-batch depth take pinned values only (no ``"auto"``), so JAX's
``_resolve_device_sync`` and ``_fused_depth`` reduce to the constructor's
checks.

JAX's device tier pads a fire's gather to a quantized width
(``_quantize_cap``) for static shapes; here it gathers exactly the emitted
rows.  JAX stages only on the host tier; here the device tier stages too
(one fold over the concatenated batches adds each cell's rows in the same
order as the per-batch folds, so the replica's bits are the same).

Options of the JAX operator that belong to later slices raise
``NotImplementedError`` here (see :data:`_LATER`); nothing falls back.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from flink_tpu_torch import DeviceLike, resolve_device
from flink_tpu_torch.core.batch import (LONG_MIN, RecordBatch, StreamElement,
                                        Watermark)
from flink_tpu_torch.core.functions import (SCATTER_UFUNCS, AggregateFunction,
                                            torch_dtype, tree_leaves,
                                            tree_structure, tree_unflatten)
from flink_tpu_torch.operators.base import StreamOperator
from flink_tpu_torch.operators.fused_step import (MAX_STAGED_ROWS,
                                                  SuperBatchStage,
                                                  concat_staged)
from flink_tpu_torch.ops.scatter import (combine_along_axis,
                                         ordered_fold_counts,
                                         scatter_fold_counts)
from flink_tpu_torch.ops.shapes import next_pow2 as _next_pow2
from flink_tpu_torch.state.device_keyindex import (DeviceKeyIndex, probe,
                                                   probe_fold,
                                                   probe_fold_available)
from flink_tpu_torch.state.keyindex import KeyIndex, NativeKeyIndex
from flink_tpu_torch.state.native_mirror import NativeWindowMirror, ineligible
from flink_tpu_torch.windowing.assigners import WindowAssigner
from flink_tpu_torch.windowing.triggers import EventTimeTrigger, Trigger

#: what this slice leaves out, and the later slice that brings it
_LATER = {
    "auto": "the auto calibrations (emit tier, device sync, device probe, "
            "superbatch=0, native_shards=0 with native_emit=True) come with "
            "the calibration slice",
    "pipeline": "pipeline_depth > 0 comes with the pipelining slice",
    "paging": "cold-key paging comes with the paging slice",
    "sharding": "sharded state comes with the multi-GPU mesh slice",
    "count": "count triggers come with the count-window slice",
    "late_output": "late side outputs come with the runtime-stack slice",
    "incremental": "incremental snapshots come with the checkpoint slice",
    "queryable": "queryable views come with the serving slice",
    "object_keys": "non-integer keys come with the object-key slice",
    "processing_time": "processing-time windows come with the runtime-stack "
                       "slice",
    "evolution": "accumulator schema evolution on restore comes with the "
                 "checkpoint slice",
    "generic": "aggregates without scatter kinds (scatter_generic) come "
               "with the keyed-reduce slice",
}


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"not in this slice of flink_tpu_torch: "
                               f"{_LATER[what]}")


def _take_rows(values, idx: np.ndarray):
    """Rows ``idx`` of a host value tree."""
    return tree_unflatten(tree_structure(values),
                          [np.asarray(a)[idx] for a in tree_leaves(values)])


def _fetch_enqueue(tensors) -> tuple:
    """Start device->host copies of whole result tensors; returns a handle
    for :func:`_fetch_collect`.  CUDA tensors copy ``non_blocking`` into
    pinned host tensors, and an event recorded after the copies tells when
    they are done; the device tensors stay referenced by the handle until it
    is collected.  CPU tensors are ready at once (no event)."""
    if all(t.device.type == "cpu" for t in tensors):
        return list(tensors), None, ()
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event, tuple(tensors)


def _handle_ready(handle) -> bool:
    """True when the handle's copies have completed (never blocks)."""
    return handle[1] is None or handle[1].query()


def _fetch_collect(handle) -> List[np.ndarray]:
    """Wait for the handle's copies; the host arrays."""
    host, event, _ = handle
    if event is not None:
        event.synchronize()
    return [h.numpy() for h in host]


class _PhaseTimer:
    """Accumulates host wall time into a dict entry (phase breakdown)."""

    __slots__ = ("_d", "_k", "_t0")

    def __init__(self, d: Dict[str, int], key: str):
        self._d = d
        self._k = key

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._d[self._k] = (self._d.get(self._k, 0)
                            + time.perf_counter_ns() - self._t0)
        return False


class WindowAggOperator(StreamOperator):
    """Keyed window aggregation: ``key_by(key_col).window(assigner).aggregate(agg)``.

    The constructor takes the JAX operator's parameter names, so one set of
    keyword arguments builds either; ``max_batch`` is accepted and unused
    (as it is there), ``device`` is the port's own."""

    def __init__(
        self,
        assigner: WindowAssigner,
        agg: AggregateFunction,
        key_column: str,
        value_selector: Optional[Callable[[Dict[str, Any]], Any]] = None,
        value_column: Optional[str] = None,
        allowed_lateness_ms: int = 0,
        trigger: Optional[Trigger] = None,
        output_column: str = "result",
        emit_window_bounds: bool = True,
        initial_key_capacity: int = 1 << 10,
        initial_panes: int = 16,
        max_batch: int = 1 << 16,
        name: str = "window-agg",
        sharding=None,
        async_fire: bool = False,
        late_output_tag: Optional[str] = None,
        emit_tier: str = "host",
        snapshot_source: str = "mirror",
        native_emit: bool = False,
        device_sync: str = "scatter",
        paging=None,
        pipeline_depth: int = 0,
        native_shards: int = 0,
        device_probe: str = "on",
        queryable: Optional[str] = None,
        superbatch: int = 1,
        device: DeviceLike = None,
    ):
        if trigger is None:
            trigger = EventTimeTrigger()
        refusals = [
            ("auto", "auto" in (emit_tier, snapshot_source, device_sync,
                                device_probe) or int(superbatch) == 0
             or (bool(native_emit) and int(native_shards) == 0
                 and emit_tier == "host")),
            ("pipeline", int(pipeline_depth) != 0),
            ("paging", paging is not None),
            ("sharding", sharding is not None),
            ("count", trigger.fires_on_count),
            ("late_output", late_output_tag is not None),
            ("queryable", queryable is not None),
            ("processing_time", not assigner.is_event_time),
            ("generic", agg.scatter_kind_leaves() is None),
        ]
        for what, refused in refusals:
            if refused:
                raise _later(what)
        if emit_tier not in ("host", "device") \
                or snapshot_source not in ("mirror", "device"):
            raise ValueError(
                f"emit_tier must be host|device and snapshot_source "
                f"mirror|device, got {emit_tier!r}/{snapshot_source!r}")
        if snapshot_source == "mirror" and emit_tier != "host":
            raise ValueError("snapshot_source='mirror' requires the host "
                             "emit tier")
        if device_sync not in ("scatter", "deferred"):
            raise ValueError(f"device_sync must be scatter|deferred, "
                             f"got {device_sync!r}")
        if device_sync == "deferred" and emit_tier != "host":
            raise ValueError(
                "device_sync='deferred' requires the unsharded host emit "
                "tier (the host mirror must be the authoritative copy)")
        if device_sync == "deferred" and snapshot_source != "mirror":
            raise ValueError(
                "device_sync='deferred' requires snapshot_source="
                "'mirror' (device-sourced snapshots would read a stale "
                "replica)")
        if device_probe not in ("on", "off"):
            raise ValueError(f"device_probe must be on|off, "
                             f"got {device_probe!r}")
        if int(superbatch) < 1:
            raise ValueError(f"superbatch must be >= 1, got {superbatch!r}")
        if int(native_shards) < 0:
            raise ValueError(f"native_shards must be >= 1, got "
                             f"{native_shards!r}")
        if emit_tier == "host" and (not trigger.fires_on_time
                                    or not agg.supports_host_emit()):
            raise ValueError(
                "emit_tier='host' requires a time-triggered window over an "
                "aggregate with numpy twins "
                "(AggregateFunction.supports_host_emit)")
        self.device = resolve_device(device)
        self.assigner = assigner
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
        self.device_probe = device_probe
        #: which memory serves fires ("host": the value mirror; "device":
        #: gathers from the replica) and snapshots ("mirror" / "device")
        self.emit_tier = emit_tier
        self.snapshot_source = snapshot_source
        #: device tier: fires start their download and surface later
        self.async_fire = bool(async_fire)
        #: in-flight async fires: (window id, keys, fetch handle, structure)
        self._pending_fires: List[tuple] = []
        #: the replica's sync cadence (JAX's resolved attribute of the same
        #: name; only pinned values exist here)
        self.device_sync_mode = device_sync
        #: deferred sync: the replica lags the mirror until device_refresh
        self._device_stale = False
        #: fused lane: staging depth (1 = off), stage and counters
        self.superbatch = int(superbatch)
        self._fused_stage = SuperBatchStage()
        self._fused_counters = {"flushes": 0, "staged_batches": 0,
                                "scan_dispatches": 0, "scan_steps": 0,
                                "host_super_passes": 0}

        self.spec = agg.acc_spec()
        self.kinds = agg.scatter_kind_leaves()
        #: mirror leaf dtypes: integer leaves widen to int64, floats to
        #: float64 — the host tier is the higher-precision replica
        self._mirror_dtypes = tuple(
            np.int64 if np.issubdtype(np.dtype(d), np.integer) else np.float64
            for d in self.spec.leaf_dtypes)
        #: the C host layer: keydict + WinMirror, bound per key index
        self.native_emit = bool(native_emit)
        self.native_shards = int(native_shards)
        if self.native_emit and emit_tier == "host":
            why = ineligible(self.spec, self.kinds, self._mirror_dtypes)
            if why is not None:
                raise ValueError(f"native_emit=True: {why}")
        self._nm: Optional[NativeWindowMirror] = None
        #: host value mirror: pane id -> [counts int64 [K], leaf_0 [K], ...]
        #: (host tier)
        self._vmirror: Dict[int, list] = {}
        #: host emit mirror: pane id -> bool [K], the key slots holding data
        #: in that pane (device tier)
        self._mirror: Dict[int, np.ndarray] = {}
        #: per-phase host wall ns and transfer bytes
        self.phase_ns: Dict[str, int] = {}
        self.phase_bytes: Dict[str, int] = {}

        # ring geometry — P must exceed the live pane span
        self._P = _next_pow2(max(initial_panes, 2 * assigner.panes_per_window))
        self._K = _next_pow2(initial_key_capacity)
        self.key_index = None        # KeyIndex, or NativeKeyIndex
        self._leaves = None          # tuple of [K, P, *leaf] device tensors
        self._counts = None          # int32 [K, P]
        self.pane_base: Optional[int] = None   # smallest retained pane id
        self.max_pane: Optional[int] = None    # largest pane seen
        self.last_fired_window: Optional[int] = None
        self.watermark: int = LONG_MIN
        self.late_dropped: int = 0

        # ---- device-resident key probe lane
        self._dki: Optional[DeviceKeyIndex] = None
        self._devprobe_resolved: Optional[bool] = None
        self._delta_leaves = None             # mirror-dtype [K, P] tensors
        self._delta_counts = None             # int32 [K, P]
        self._delta_panes: set = set()        # panes with unsynced delta
        self._dp_stats = {"probe_hits": 0, "probe_misses": 0,
                          "miss_inserts": 0, "delta_syncs": 0}

    # ------------------------------------------------------------------ state
    def _alloc(self, K: int, P: int):
        leaves = tuple(
            torch.full((K, P) + tuple(shape), np.asarray(init).item(),
                       dtype=torch_dtype(dtype), device=self.device)
            for init, shape, dtype in zip(self.spec.leaf_inits,
                                          self.spec.leaf_shapes,
                                          self.spec.leaf_dtypes))
        counts = torch.zeros((K, P), dtype=torch.int32, device=self.device)
        return leaves, counts

    def _ensure_alloc(self):
        if self._leaves is None:
            self._leaves, self._counts = self._alloc(self._K, self._P)

    def _phase(self, name: str):
        return _PhaseTimer(self.phase_ns, name)

    def _to_device(self, values):
        """Host value tree -> the same structure of device tensors."""
        leaves = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                  for a in tree_leaves(values)]
        self.phase_bytes["h2d"] = (self.phase_bytes.get("h2d", 0)
                                   + sum(l.nbytes for l in leaves))
        return tree_unflatten(tree_structure(values), leaves)

    def _ids_to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        self.phase_bytes["h2d"] = self.phase_bytes.get("h2d", 0) + t.nbytes
        return t

    # ------------------------------------------------- native host layer
    @property
    def native_mirror_active(self) -> bool:
        """True while the C mirror serves this operator (native_emit=True,
        from the first batch or a restore on)."""
        return self._nm is not None

    def _bind_key_index(self, snap=None) -> None:
        """A fresh key index (restored from ``snap`` if given) and, with
        native_emit on the host tier, the C mirror sharing its keydict (the
        device tier binds the keydict alone, as JAX does).  The old mirror
        is dropped first: it pins the old keydict, never the new one."""
        self._nm = None
        cls = NativeKeyIndex if self.native_emit else KeyIndex
        self.key_index = (cls.restore(snap) if snap is not None else
                          cls(initial_capacity=max(1 << 16, 2 * self._K)))
        if self.native_emit and self.emit_tier == "host":
            self._nm = NativeWindowMirror.create(
                self.key_index, self.spec, self.kinds, self._mirror_dtypes)

    def _native_probe_update(self, keys, panes, values, flat_out=None):
        """The C pass over a block of rows: key inserts (numbered by first
        occurrence) and the mirror fold; with ``flat_out`` also the device
        scatter ids ``slot * P + pane % P``.  Returns the rows' slots."""
        lifted = [np.asarray(l)
                  for l in tree_leaves(self.agg.host_lift(values))]
        return self._nm.probe_update(
            keys, panes, lifted,
            pane_mod=self._P if flat_out is not None else 0,
            flat_out=flat_out, shards=self.native_shards)

    def reset_state(self) -> None:
        """Drop all keyed state and time progress (the key index, its C
        mirror, the device state, the probe table, the stage and the
        counters); the configuration stays.  The next batch binds a fresh
        key index and mirror."""
        self._fused_stage.take()
        self.key_index = None
        self._nm = None          # its keydict dies with the key index
        self._leaves = None
        self._counts = None
        self._vmirror = {}
        self._mirror = {}
        self._pending_fires = []
        self.pane_base = None
        self.max_pane = None
        self.last_fired_window = None
        self.watermark = LONG_MIN
        self.late_dropped = 0
        self.phase_ns = {}
        self.phase_bytes = {}
        self._fused_counters = {k: 0 for k in self._fused_counters}
        self._device_stale = False
        self._dki = None
        self._drop_delta()
        self._devprobe_resolved = None
        self._dp_stats = {k: 0 for k in self._dp_stats}

    # ----------------------------------------------- device-resident probe
    def _devprobe_active(self) -> bool:
        """Resolved once per key-index lifetime: "on" and eligible (the
        host emit tier, scalar add/min/max accumulator leaves — the delta
        fold contract), as JAX's ``_devprobe_eligible``."""
        if self._devprobe_resolved is None:
            self._devprobe_resolved = (
                self.device_probe == "on"
                and self.emit_tier == "host"
                and self.kinds is not None
                and all(tuple(s) == () for s in self.spec.leaf_shapes))
        return self._devprobe_resolved

    def device_probe_stats(self) -> Dict[str, Any]:
        """Probe counters: hits, misses, table inserts, delta syncs."""
        s = dict(self._dp_stats)
        total = s["probe_hits"] + s["probe_misses"]
        s["enabled"] = int(bool(self._devprobe_resolved))
        s["probe_hit_rate"] = (s["probe_hits"] / total) if total else None
        s["delta_d2h_bytes"] = int(self.phase_bytes.get("delta_d2h", 0))
        return s

    def _drop_delta(self) -> None:
        self._delta_leaves = None
        self._delta_counts = None
        self._delta_panes = set()

    def _ensure_delta(self) -> None:
        """Allocate the device DELTA ring [K, P] in the mirror dtypes (f64 /
        i64 values, int32 counts): warm-row folds carry exactly the
        precision the host mirror fold would have."""
        if self._delta_counts is not None \
                and tuple(self._delta_counts.shape) == (self._K, self._P):
            return
        self._delta_leaves = tuple(
            torch.full((self._K, self._P), np.asarray(init).astype(mdt).item(),
                       dtype=torch_dtype(mdt), device=self.device)
            for init, mdt in zip(self.spec.leaf_inits, self._mirror_dtypes))
        self._delta_counts = torch.zeros((self._K, self._P), dtype=torch.int32,
                                         device=self.device)
        self._delta_panes = set()

    def _flat_state(self, leaves, counts):
        K, P = counts.shape
        return (tuple(l.view((K * P,) + tuple(l.shape[2:])) for l in leaves),
                counts.view(K * P))

    def _probed_update_step(self, buckets, keys, pane_slots,
                            values) -> torch.Tensor:
        """One micro-batch with the key probe on the card: probe the table
        with the int64 keys, fold hit rows into the device replica (device
        precision) and the delta ring (mirror precision), in place.  Miss
        rows carry the dropped id K*P.  Returns the miss rows' indices
        (int64, ascending); computing it is the step's one host sync."""
        slot = probe(buckets, keys)
        hit = slot >= 0
        K, P = self._counts.shape
        flat = torch.where(hit, slot.to(torch.int64) * P + pane_slots, K * P)
        lifted = tuple(tree_leaves(self.agg.lift(values)))
        scatter_fold_counts(*self._flat_state(self._leaves, self._counts),
                            flat, lifted, self.kinds)
        scatter_fold_counts(*self._flat_state(self._delta_leaves,
                                              self._delta_counts),
                            flat, lifted, self.kinds)
        return torch.nonzero(~hit).squeeze(1)

    def _probed_delta_step(self, buckets, keys, pane_slots,
                           values) -> torch.Tensor:
        """Deferred-sync twin of :meth:`_probed_update_step`: the mirror is
        the authority, so hit rows fold into the delta ring only (the
        replica catches up at :meth:`device_refresh`)."""
        slot = probe(buckets, keys)
        hit = slot >= 0
        K, P = self._delta_counts.shape
        flat = torch.where(hit, slot.to(torch.int64) * P + pane_slots, K * P)
        lifted = tuple(tree_leaves(self.agg.lift(values)))
        scatter_fold_counts(*self._flat_state(self._delta_leaves,
                                              self._delta_counts),
                            flat, lifted, self.kinds)
        return torch.nonzero(~hit).squeeze(1)

    def _fused_scan_delta_step(self, buckets, keys, pane_slots,
                               values) -> torch.Tensor:
        """Deferred-sync step of the fused lane over a whole super-batch:
        ONE ``probe_fold`` launch probes every row and folds the hit rows
        into the delta ring in row order.  Where :func:`probe_fold_available`
        says no (not a single ``add`` leaf), the block takes
        :meth:`_probed_delta_step`, as JAX's scan body takes probe + scatter
        when its Pallas gate says no.  Returns the miss rows (int64,
        ascending)."""
        if not probe_fold_available(self.kinds, self._delta_leaves[0].dtype):
            return self._probed_delta_step(buckets, keys, pane_slots,
                                           values)
        (dsum,), dcnt = self._flat_state(self._delta_leaves,
                                         self._delta_counts)
        (vals,) = tree_leaves(self.agg.lift(values))
        slot, _, _ = probe_fold(buckets, keys, pane_slots, keys.shape[0],
                                vals, dsum, dcnt, self._P)
        return torch.nonzero(slot < 0).squeeze(1)

    def _delta_clear_step(self, pane_slots: torch.Tensor) -> None:
        """Reset synced (or expired) delta columns to identity, in place."""
        for l, init, mdt in zip(self._delta_leaves, self.spec.leaf_inits,
                                self._mirror_dtypes):
            l[:, pane_slots] = np.asarray(init).astype(mdt).item()
        self._delta_counts[:, pane_slots] = 0

    def _devprobe_sync_mirror(self, panes=None) -> None:
        """Pane-granular mirror catch-up: pull the delta columns of ``panes``
        (None = every unsynced pane) for the live key rows, fold them into
        the host value mirror, and reset those delta columns on the card.
        Identity delta rows fold as no-ops, so no mask rides the pull."""
        if self._delta_counts is None or not self._delta_panes:
            return
        if panes is None:
            sync = sorted(self._delta_panes)
        else:
            want = {int(p) for p in np.asarray(panes).reshape(-1).tolist()}
            sync = sorted(self._delta_panes & want)
        if not sync:
            return
        n = self.key_index.num_keys if self.key_index is not None else 0
        if n == 0:
            self._delta_panes.difference_update(sync)
            return
        with self._phase("delta_sync"):
            slots = torch.tensor([p % self._P for p in sync],
                                 dtype=torch.int64, device=self.device)
            cnt_np = self._delta_counts[:n].index_select(1, slots).cpu().numpy()
            sel_np = [l[:n].index_select(1, slots).cpu().numpy()
                      for l in self._delta_leaves]
            self._delta_clear_step(slots)
            self.phase_bytes["delta_d2h"] = (
                self.phase_bytes.get("delta_d2h", 0) + cnt_np.nbytes
                + sum(l.nbytes for l in sel_np))
            for j, p in enumerate(sync):
                col_cnt = cnt_np[:, j]
                if not col_cnt.any():
                    continue
                if self._nm is not None:
                    self._nm.apply_delta(int(p), col_cnt.astype(np.int64),
                                         [l[:, j] for l in sel_np])
                    continue
                entry = self._vmirror_pane(int(p))
                entry[0][:n] += col_cnt
                for k, kind in enumerate(self.kinds):
                    entry[k + 1][:n] = SCATTER_UFUNCS[kind](
                        entry[k + 1][:n],
                        sel_np[k][:, j].astype(self._mirror_dtypes[k],
                                               copy=False))
            self._delta_panes.difference_update(sync)
            self._dp_stats["delta_syncs"] += 1

    def _devprobe_begin(self) -> None:
        """Probe-lane set-up: replica, delta ring and device table exist,
        and the table holds every key of the key index."""
        self._ensure_alloc()
        self._ensure_delta()
        if self._dki is None:
            self._dki = DeviceKeyIndex(
                initial_capacity=max(1 << 16, 2 * self._K), device=self.device)
        self._dki.ensure_loaded(self.key_index)   # bulk/restore load

    def _devprobe_dispatch(self, step, keys: np.ndarray, panes: np.ndarray,
                           values, B: int) -> np.ndarray:
        """Upload a block of rows (the int64 keys as they are, their pane
        slots, the values) and run the probed ``step`` on it; count hits and
        misses.  The card hashes the keys, so the host does no per-record
        hash or split.  Returns the miss rows' indices on the host."""
        miss_idx = step(self._dki.buckets,
                        self._ids_to_device(np.ascontiguousarray(keys,
                                                                 np.int64)),
                        self._ids_to_device((panes % self._P).astype(
                            np.int32)),
                        self._to_device(values))
        mc = int(miss_idx.numel())
        self._delta_panes.update(int(p) for p in np.unique(panes).tolist())
        self._dp_stats["probe_hits"] += B - mc
        self._dp_stats["probe_misses"] += mc
        if self.device_sync_mode == "deferred":
            self._device_stale = True
        return miss_idx.cpu().numpy() if mc else np.zeros(0, np.int64)

    def _hot_stage_devprobe(self, keys: np.ndarray, panes: np.ndarray,
                            values, B: int) -> None:
        """Probe-lane hot stage of one batch: one device step probes and
        folds the warm rows; the host pass then touches only the compact
        miss list."""
        self._devprobe_begin()
        step = (self._probed_delta_step if self.device_sync_mode == "deferred"
                else self._probed_update_step)
        with self._phase("device_probe"):
            mi = self._devprobe_dispatch(step, keys, panes, values, B)
        if mi.size:
            mslots, mpanes, mvalues = self._devprobe_absorb_rows(
                keys, panes, values, mi)
            if self.device_sync_mode == "scatter":
                self._miss_replica_update(mslots, mpanes, mvalues)

    def _devprobe_absorb_misses(self, mkeys, mpanes, mvalues) -> np.ndarray:
        """Host pass over the miss rows: key insert and mirror fold (one C
        pass with the native mirror; else the numpy key index, and the numpy
        fold after growth), key growth (with a delta drain and rebuild), one
        table scatter.  Returns the miss rows' slot ids."""
        with self._phase("probe_mirror"):
            if self._nm is not None:
                mslots = self._native_probe_update(mkeys, mpanes, mvalues)
            else:
                mslots = self.key_index.lookup_or_insert(mkeys)
        if self.key_index.num_keys > self._K:
            # growth reallocates the delta ring: drain it into the mirror
            # first so no warm contribution is lost, then rebuild at new K
            self._devprobe_sync_mirror(None)
            self._drop_delta()
            self._grow_keys(self.key_index.num_keys)
            self._ensure_delta()
        if self._nm is None:
            with self._phase("mirror"):
                self._vmirror_update(mslots, mpanes, mvalues)
        self._dp_stats["miss_inserts"] += \
            self._dki.ensure_loaded(self.key_index)
        return mslots

    def _devprobe_absorb_rows(self, keys, panes, values, mi: np.ndarray):
        """The host pass over the miss rows ``mi`` of a block; returns their
        (slots, panes, values) for the replica catch-up."""
        mkeys = np.ascontiguousarray(keys[mi])
        mpanes = np.ascontiguousarray(panes[mi])
        mvalues = _take_rows(values, mi)
        return (self._devprobe_absorb_misses(mkeys, mpanes, mvalues),
                mpanes, mvalues)

    def _miss_replica_update(self, mslots, mpanes, mvalues) -> None:
        """Replica catch-up for probe-miss rows: host-built flat ids through
        the plain update step."""
        flat = mslots.astype(np.int64) * self._P + (mpanes % self._P)
        with self._phase("device_dispatch"):
            self._update_step(self._ids_to_device(flat),
                              self._to_device(mvalues))

    # ------------------------------------------------------------ fused lane
    def fused_stats(self) -> Dict[str, int]:
        """Fused-lane counters, under JAX's names: batches staged, flushes,
        one-step passes over a super-batch with the probe on
        (``scan_dispatches``) and the batches they covered
        (``scan_steps``), concatenated passes with the probe off
        (``host_super_passes``), and the batches parked now."""
        s = dict(self._fused_counters)
        s["enabled"] = int(self.superbatch > 1)
        s["depth"] = self.superbatch
        s["staged_pending"] = len(self._fused_stage)
        return s

    def flush_pipeline(self) -> List[StreamElement]:
        """Barrier before any state read: advance every staged batch.  The
        operator calls it before fires, expiry, snapshots, restore,
        verification, refresh and late re-fires; a task loop may call it at
        idle points.  A no-op when nothing is staged."""
        self._fused_flush()
        return []

    def _fused_flush(self) -> None:
        """Advance every staged batch in one pass: with the probe on and
        more than one batch staged, the one-step lane
        (:meth:`_fused_flush_scan`); else the staged batches concatenate and
        take the per-batch path once.  A single staged batch (drained by a
        fire boundary or a state read) is the plain per-batch path, not a
        super pass."""
        if not self._fused_stage:
            return
        st = self._fused_stage.take()
        self._fused_counters["flushes"] += 1
        if len(st) > 1 and self._devprobe_active():
            self._fused_flush_scan(st)
            return
        if len(st) == 1:
            keys, panes, values, B = st[0]
        else:
            self._fused_counters["host_super_passes"] += 1
            with self._phase("fused_scan"):
                keys, panes, values, B = concat_staged(st)
        self._advance_batch(keys, panes, values, B)

    def _fused_flush_scan(self, st) -> None:
        """The one-step lane (JAX's scan lane): the staged batches
        concatenate into one block of R rows and ONE device step probes and
        folds all of them — under deferred sync one ``probe_fold`` launch
        (:meth:`_fused_scan_delta_step`), under scatter sync the probed
        update step over the block.  JAX pads the batches into an ``[N, B]``
        block and runs a ``lax.scan``; no scan is needed because the device
        table does not change during the pass, so the N steps' probes are
        independent and their folds equal one fold over the block in
        step-then-row order.  The miss rows come back with one
        ``torch.nonzero``, the flush's only host sync."""
        self._devprobe_begin()
        step = (self._fused_scan_delta_step
                if self.device_sync_mode == "deferred"
                else self._probed_update_step)
        with self._phase("fused_scan"):
            keys, panes, values, R = concat_staged(st)
            mi = self._devprobe_dispatch(step, keys, panes, values, R)
        self._fused_counters["scan_dispatches"] += 1
        self._fused_counters["scan_steps"] += len(st)
        if mi.size:
            self._fused_handle_misses(st, keys, panes, values, mi)

    def _fused_handle_misses(self, st, keys, panes, values,
                             mi: np.ndarray) -> None:
        """The host pass over a super-batch's miss rows (indices into the
        concatenated block), split by step with the batches' offsets and
        absorbed in step order, so new keys get the slot ids the per-batch
        path assigns.  A key first seen in step i misses in every later step
        too; those rows fold into the same mirror cells the warm path would
        have used.  Under scatter sync ONE replica update then folds every
        step's miss rows.

        With the native mirror the miss rows take ONE C pass in block order.
        It assigns the slots that one pass per step would (the keydict
        numbers by first occurrence) and folds each cell in the same row
        order, so the mirror's bits are the same too.  A key growth then
        drains the delta once, after every step's rows rather than between
        two steps, which changes no bit: the delta holds only keys that
        were in the device table before the flush, and those never miss."""
        if self._nm is not None:
            slots = self._devprobe_absorb_rows(keys, panes, values, mi)[0]
            if self.device_sync_mode == "scatter":
                self._miss_replica_update(slots, panes[mi],
                                          _take_rows(values, mi))
            return
        bounds = np.cumsum([0] + [int(s[3]) for s in st])
        cuts = np.searchsorted(mi, bounds)
        slots = [self._devprobe_absorb_rows(keys, panes, values,
                                            mi[lo:hi])[0]
                 for lo, hi in zip(cuts[:-1], cuts[1:]) if hi > lo]
        if self.device_sync_mode == "scatter":
            self._miss_replica_update(np.concatenate(slots), panes[mi],
                                      _take_rows(values, mi))

    def _advance_batch(self, keys: np.ndarray, panes: np.ndarray, values,
                       B: int) -> None:
        """The probe lane or the plain fold lane for one block of rows."""
        if self._devprobe_active():
            self._hot_stage_devprobe(keys, panes, values, B)
        else:
            self._hot_stage_fold(keys, panes, values)

    # -------------------------------------------------- deferred sync point
    def device_refresh(self) -> None:
        """Rebuild the device replica from the authoritative host mirror:
        deferred sync's sync point (verification, or a caller's explicit
        hand-off).  Set semantics over the whole ring: slots without a live
        pane reset to identity, which also applies the expirations skipped
        while deferred.  The upload covers live panes x live key rows.  A
        no-op when the replica is current."""
        self.flush_pipeline()
        if not self._device_stale:
            return
        self._device_stale = False
        if self.key_index is None or self.pane_base is None:
            return
        self._ensure_alloc()
        # drain the delta BEFORE listing live panes: a pane whose rows all
        # hit the probe exists only in the delta until then (the JAX
        # operator lists first and leaves such a pane at identity)
        self._devprobe_sync_mirror(None)
        n = self.key_index.num_keys
        present = (set(self._nm.live_panes().tolist()) if self._nm is not None
                   else set(self._vmirror))
        live = [p for p in range(self.pane_base, self.max_pane + 1)
                if p in present]
        counts_cols, leaf_cols = self._mirror_columns(live, n)
        self._refresh_step(live, counts_cols, leaf_cols)
        self.phase_bytes["h2d_refresh"] = (
            self.phase_bytes.get("h2d_refresh", 0) + counts_cols.nbytes
            + sum(l.nbytes for l in leaf_cols))

    def _refresh_step(self, live, counts_cols, leaf_cols) -> None:
        """Replace the whole ring in place: identity everywhere, then the
        live panes' columns (``[rows, len(live)]``) at their ring slots."""
        for l, init in zip(self._leaves, self.spec.leaf_inits):
            l.fill_(np.asarray(init).item())
        self._counts.zero_()
        if not live:
            return
        rows = counts_cols.shape[0]
        slots = torch.from_numpy(np.asarray(live, np.int64) % self._P).to(
            self.device)
        for l, col in zip(self._leaves, leaf_cols):
            l[:rows, slots] = torch.from_numpy(np.ascontiguousarray(col)).to(
                self.device, l.dtype)
        self._counts[:rows, slots] = torch.from_numpy(counts_cols).to(
            self.device)

    # ---------------------------------------------------------- emit mirror
    def _mirror_mark(self, pane: int, slots: np.ndarray) -> None:
        """Record that key ``slots`` hold data in ``pane`` (device tier)."""
        arr = self._mirror.get(pane)
        if arr is None or arr.size < self._K:
            grown = np.zeros(self._K, bool)
            if arr is not None:
                grown[:arr.size] = arr
            arr = self._mirror[pane] = grown
        arr[slots] = True

    def _mirror_mark_batch(self, slots: np.ndarray,
                           panes: np.ndarray) -> None:
        """Mark a block's (slot, pane) cells, pane by pane."""
        p0, p1 = int(panes.min()), int(panes.max())
        if p0 == p1:
            self._mirror_mark(p0, slots)
            return
        cand = (range(p0, p1 + 1) if p1 - p0 < 64
                else np.unique(panes).tolist())
        for p in cand:
            m = panes == p
            if m.any():
                self._mirror_mark(int(p), slots[m])

    def _mirror_emit_idx(self, panes: np.ndarray) -> np.ndarray:
        """Exact ascending key-slot ids that hold data in any of ``panes``."""
        n = self.key_index.num_keys if self.key_index is not None else 0
        acc = None
        for p in panes.tolist():
            arr = self._mirror.get(int(p))
            if arr is None:
                continue
            a = arr[:n] if arr.size >= n else np.pad(arr, (0, n - arr.size))
            acc = a.copy() if acc is None else (acc | a)
        if acc is None:
            return np.empty(0, np.int64)
        return np.flatnonzero(acc)

    # ---------------------------------------------------- host value mirror
    def _vmirror_pane(self, pane: int) -> list:
        """[counts, *leaves] arrays of a pane, allocated/grown to K rows."""
        need = self._K
        entry = self._vmirror.get(pane)
        if entry is None or entry[0].size < need:
            fresh = [np.zeros(need, np.int64)]
            for init, shape, mdt in zip(self.spec.leaf_inits,
                                        self.spec.leaf_shapes,
                                        self._mirror_dtypes):
                arr = np.empty((need,) + tuple(shape), mdt)
                arr[...] = np.asarray(init).astype(mdt)
                fresh.append(arr)
            if entry is not None:
                n = entry[0].size
                for f, o in zip(fresh, entry):
                    f[:n] = o
            entry = self._vmirror[pane] = fresh
        return entry

    @staticmethod
    def _host_scatter(kind: str, arr: np.ndarray, slots: np.ndarray,
                      vals: np.ndarray) -> None:
        """In-place segment combine ``arr[slots] op= vals`` (numpy twin of
        ops/scatter.py): add on scalar leaves is one bincount; min/max and
        non-scalar leaves sort + ufunc.reduceat."""
        if kind == "add" and vals.ndim == 1:
            arr += np.bincount(slots, weights=vals,
                               minlength=arr.size).astype(arr.dtype,
                                                          copy=False)
            return
        ufunc = SCATTER_UFUNCS[kind]
        order = np.argsort(slots, kind="stable")
        ss = slots[order]
        vv = vals[order]
        starts = np.flatnonzero(np.r_[True, ss[1:] != ss[:-1]])
        red = ufunc.reduceat(vv, starts, axis=0)
        uniq = ss[starts]
        arr[uniq] = ufunc(arr[uniq], red)

    def _vmirror_update(self, slots: np.ndarray, panes: np.ndarray,
                        values) -> None:
        """Fold a batch into the host mirror — the same (slot, pane, value)
        triples as the device fold, with the aggregate's numpy twins."""
        lifted = [np.asarray(l)
                  for l in tree_leaves(self.agg.host_lift(values))]
        for p in np.unique(panes).tolist():
            m = panes == p
            s = slots[m] if not m.all() else slots
            entry = self._vmirror_pane(int(p))
            entry[0] += np.bincount(s, minlength=entry[0].size)
            for j, (kind, leaf) in enumerate(zip(self.kinds, lifted)):
                self._host_scatter(kind, entry[j + 1], s,
                                   leaf[m] if not m.all() else leaf)

    def _mirror_columns(self, panes, rows: int):
        """Dense device-dtype columns of the mirror: counts int32 [rows,
        len(panes)] plus one [rows, len(panes), *shape] array per leaf
        (missing panes = identity).  Drains every unsynced delta first."""
        self._devprobe_sync_mirror(None)
        counts = np.zeros((rows, len(panes)), np.int32)
        leaves = []
        for init, shape, d in zip(self.spec.leaf_inits, self.spec.leaf_shapes,
                                  self.spec.leaf_dtypes):
            arr = np.empty((rows, len(panes)) + tuple(shape), d)
            arr[...] = np.asarray(init).astype(d)
            leaves.append(arr)
        for j, p in enumerate(panes):
            if self._nm is not None:
                # views of the export scratch: consumed before the next pane
                ex, cnts, lvs = self._nm.export_pane(int(p), rows)
                if not ex:
                    continue
                e = [cnts] + lvs
            else:
                e = self._vmirror.get(int(p))
                if e is None:
                    continue
            counts[:, j] = e[0][:rows]
            for k, dst in enumerate(leaves):
                dst[:, j] = e[k + 1][:rows].astype(self.spec.leaf_dtypes[k],
                                                   copy=False)
        return counts, leaves

    def verify_mirror(self, atol: float = 1e-3, rtol: float = 1e-4) -> bool:
        """Download the device replica's live panes and compare with the
        host mirror (compared in device precision: the mirror has more
        bits).  Meant for tests and sampled validation.  Under deferred sync
        the replica is refreshed first, so the check covers the refresh
        round trip (ring mapping, dtype casts, skipped expirations)."""
        self.flush_pipeline()
        if self.device_sync_mode == "deferred":
            self.device_refresh()
        self._devprobe_sync_mirror(None)
        if self.emit_tier != "host" or self._leaves is None \
                or self.pane_base is None:
            return True     # the device tier has no value mirror
        n = self.key_index.num_keys if self.key_index else 0
        for p in range(self.pane_base, (self.max_pane or 0) + 1):
            slot = int(p) % self._P
            if self._nm is not None:
                _ex, cnts, lvs = self._nm.export_pane(p, n)
                host = [cnts] + lvs
            else:
                host = self._vmirror.get(p)
            host_counts = (host[0][:n] if host is not None
                           else np.zeros(n, np.int64))
            if not np.array_equal(self._counts[:n, slot].cpu().numpy(),
                                  host_counts):
                return False
            for j in range(self.spec.num_leaves):
                dev = self._leaves[j][:n, slot].cpu().numpy().astype(
                    np.float64)
                hst = (np.asarray(host[j + 1][:n], np.float64)
                       if host is not None
                       else np.broadcast_to(np.asarray(
                           self.spec.leaf_inits[j], np.float64), dev.shape))
                hst32 = hst.astype(self.spec.leaf_dtypes[j]).astype(np.float64)
                if not np.allclose(dev, hst32, atol=atol, rtol=rtol,
                                   equal_nan=True):
                    return False
        return True

    # ------------------------------------------------------------- growth
    def _grow_keys(self, needed: int):
        newK = _next_pow2(needed, self._K)
        if newK == self._K and self._leaves is not None:
            return
        old_leaves, old_counts = self._leaves, self._counts
        self._K = newK
        # grow every live mirror pane with the capacity: an untouched pane
        # must still serve fires/snapshots at the new key count
        for p in list(self._vmirror):
            self._vmirror_pane(p)
        fresh, fresh_counts = self._alloc(self._K, self._P)
        if old_leaves is not None:
            n = old_counts.shape[0]
            for f, o in zip(fresh, old_leaves):
                f[:n] = o
            fresh_counts[:n] = old_counts
        self._leaves, self._counts = fresh, fresh_counts

    def _grow_panes(self, span: int):
        """Double the pane ring until it holds ``span`` live panes, remapping
        slot = pane % P_old -> pane % P_new for retained panes."""
        newP = self._P
        while newP < span:
            newP <<= 1
        if newP == self._P:
            return
        old_leaves, old_counts, oldP = self._leaves, self._counts, self._P
        self._P = newP
        fresh, fresh_counts = self._alloc(self._K, newP)
        if old_leaves is not None and self.pane_base is not None:
            panes = np.arange(self.pane_base, self.max_pane + 1,
                              dtype=np.int64)
            src = torch.from_numpy(panes % oldP).to(self.device)
            dst = torch.from_numpy(panes % newP).to(self.device)
            for f, o in zip(fresh, old_leaves):
                f[:, dst] = o[:, src]
            fresh_counts[:, dst] = old_counts[:, src]
        self._leaves, self._counts = fresh, fresh_counts

    def _grow_panes_guarded(self, span: int) -> None:
        if self._delta_counts is not None and span > self._P:
            # the delta ring reallocates with P: drain it into the mirror
            # first, rebuild at the new P on the next probe step
            self._devprobe_sync_mirror(None)
            self._drop_delta()
        self._ensure_alloc()
        self._grow_panes(span)

    # ------------------------------------------------------------- device ops
    def _update_step(self, flat_ids: torch.Tensor, values) -> None:
        """One micro-batch fold into the device replica, in place: lift +
        the ordered fold (on the card ``csrc/scatter_fold.cu``, which adds
        each cell's rows in row order).  flat_ids in [0, K*P]; K*P is a
        dropped row."""
        lifted = tuple(tree_leaves(self.agg.lift(values)))
        ordered_fold_counts(*self._flat_state(self._leaves, self._counts),
                            flat_ids, lifted, self.kinds)

    def _clear_panes_step(self, pane_slots: torch.Tensor) -> None:
        """Reset ring columns of expired panes to identity, in place."""
        for l, init in zip(self._leaves, self.spec.leaf_inits):
            l[:, pane_slots] = np.asarray(init).item()
        self._counts[:, pane_slots] = 0

    def _rows_for(self, idx: np.ndarray, result,
                  window) -> List[StreamElement]:
        return self._rows_for_keys(
            np.asarray(self.key_index.reverse_keys())[idx], result, window)

    def _rows_for_keys(self, keys: np.ndarray, result,
                       window) -> List[StreamElement]:
        n = len(keys)
        cols: Dict[str, Any] = {self.key_column: keys}
        if isinstance(result, dict):
            cols.update(result)
        else:
            cols[self.output_column] = result
        if self.emit_window_bounds:
            cols["window_start"] = np.broadcast_to(np.int64(window.start),
                                                   (n,))
            cols["window_end"] = np.broadcast_to(np.int64(window.end), (n,))
        ts = np.broadcast_to(np.int64(window.max_timestamp), (n,))
        return [RecordBatch(cols, timestamps=ts)]

    # --------------------------------------------------------------- batching
    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        pending = self.drain_pending_fires() if self.async_fire else []
        if len(batch) == 0:
            return pending
        cols = batch.columns
        keys = np.asarray(cols[self.key_column])
        if self.key_index is None:
            if keys.dtype.kind not in "iu":
                raise _later("object_keys")
            self._bind_key_index()
        if batch.timestamps is None:
            raise ValueError("event-time window requires timestamps")
        ts = np.asarray(batch.timestamps, np.int64)
        panes = self.assigner.pane_of(ts)

        # ---- late-beyond-lateness drop, judged like the reference's
        # WindowOperator.isElementLate: a record is late iff its pane's last
        # covering window's cleanup time (end - 1 + lateness) was passed
        gate_now = self.watermark
        if gate_now != LONG_MIN:
            p0, p1 = int(panes.min()), int(panes.max())
            cand = (np.arange(p0, p1 + 1, dtype=np.int64)
                    if p1 - p0 < 64 else np.unique(panes))
            is_late = np.asarray(
                [self.assigner.last_window_end_of_pane(int(p)) - 1
                 + self.lateness <= gate_now for p in cand.tolist()])
            if not is_late.any():
                live = np.ones(0, bool)
            elif np.all(is_late[:-1] >= is_late[1:]):
                # lateness is a prefix of ascending panes
                live = panes > int(cand[int(is_late.sum()) - 1])
            else:
                live = ~np.isin(panes, cand[is_late])
            if live.size and not live.all():
                self.late_dropped += int(np.count_nonzero(~live))
                batch = batch.select(live)
                if len(batch) == 0:
                    return pending
                cols = batch.columns
                keys = np.asarray(cols[self.key_column])
                panes = panes[live]

        pmin, pmax = int(panes.min()), int(panes.max())
        values = self._select(cols)
        self._hot_stage(keys, panes, values, len(batch), pmin, pmax)

        out: List[StreamElement] = list(pending)
        # ---- late re-fire: windows already passed by the watermark that
        # this batch updated fire again (EventTimeTrigger.onElement FIRE)
        if (self.last_fired_window is not None
                and self.assigner.windows_of_pane(pmin)[0]
                <= self.last_fired_window):
            self.flush_pipeline()   # re-fires read state
            refire: List[int] = []
            for p in np.unique(panes).tolist():
                w0, w1 = self.assigner.windows_of_pane(int(p))
                for w in range(w0, w1 + 1):
                    max_ts = self.assigner.window_bounds(w).max_timestamp
                    if (w <= self.last_fired_window
                            and max_ts <= self.watermark
                            and max_ts + self.lateness > self.watermark):
                        refire.append(w)
            for w in sorted(set(refire)):
                out.extend(self._fire_window(w))
        return out

    def _hot_stage(self, keys: np.ndarray, panes: np.ndarray, values,
                   B: int, pmin: int, pmax: int) -> None:
        """Pane-ring bookkeeping/growth, then, for one micro-batch, the
        fused lane's stage (superbatch > 1), or the probe lane or the plain
        fold lane."""
        if self.pane_base is None:
            self.pane_base = pmin
            self.max_pane = pmax
        else:
            # grow BEFORE extending the live range: the remap copies the old
            # [pane_base, max_pane], alias-free only in the old geometry
            new_base = min(self.pane_base, pmin)
            span = max(self.max_pane, pmax) - new_base + 1
            if span > self._P:
                self._grow_panes_guarded(span)
            self.pane_base = new_base
            self.max_pane = max(self.max_pane, pmax)
        span = self.max_pane - self.pane_base + 1
        if span > self._P:
            self._grow_panes_guarded(span)
        if self.superbatch > 1:
            # fused lane: park the batch; the whole super-batch advances in
            # one pass at the flush boundary (depth or row bound here, a
            # fire boundary or any state read through flush_pipeline)
            self._fused_stage.push(keys, panes, values, B)
            self._fused_counters["staged_batches"] += 1
            if (len(self._fused_stage) >= self.superbatch
                    or self._fused_stage.rows >= MAX_STAGED_ROWS):
                self._fused_flush()
            return
        self._advance_batch(keys, panes, values, B)

    def _hot_stage_fold(self, keys: np.ndarray, panes: np.ndarray,
                        values) -> None:
        """Plain lane: host key lookup and mirror fold, the device fold
        (scatter sync only).  With the native mirror, one C pass does the
        lookup and the fold and, under scatter sync, writes the int32
        scatter ids the device fold takes.  On the device tier the key
        index resolves the rows, the replica takes the fold, and the emit
        mirror marks the cells."""
        flat = None
        if self._nm is not None:
            with self._phase("probe_mirror"):
                if self.device_sync_mode == "scatter":
                    flat = np.empty(len(keys), np.int32)
                self._native_probe_update(keys, panes, values, flat)
        else:
            with self._phase("probe"):
                slots = self.key_index.lookup_or_insert(keys)
        if self.key_index.num_keys > self._K:
            self._ensure_alloc()
            self._grow_keys(self.key_index.num_keys)
        self._ensure_alloc()
        if self.device_sync_mode == "deferred":
            # the mirror is the authority; the replica catches up at the
            # next device_refresh
            self._device_stale = True
        else:
            if flat is None:
                # int32 ids where the cells fit: half the upload
                idt = np.int32 if self._K * self._P < 2 ** 31 else np.int64
                flat = (slots.astype(idt) * idt(self._P)
                        + (panes % self._P).astype(idt))
            with self._phase("device_dispatch"):
                self._update_step(self._ids_to_device(flat),
                                  self._to_device(values))
        if self.emit_tier == "device":
            with self._phase("emit_mirror"):
                self._mirror_mark_batch(slots, panes)
        elif self._nm is None:
            with self._phase("mirror"):
                self._vmirror_update(slots, panes, values)

    # ------------------------------------------------------------------ time
    def _fired_horizon(self, now: int) -> int:
        """Largest window id whose maxTimestamp (= end-1) has been passed."""
        a = self.assigner
        denom = a.pane_stride * a.pane_ms
        w_max = (now + 1 - a._offset - a.panes_per_window * a.pane_ms) // denom
        while a.window_bounds(w_max + 1).max_timestamp <= now:
            w_max += 1
        while a.window_bounds(w_max).max_timestamp > now:
            w_max -= 1
        return w_max

    def process_watermark(self, watermark: Watermark) -> List[StreamElement]:
        self.watermark = max(self.watermark, watermark.timestamp)
        if (self._fused_stage and not self.async_fire and self.lateness == 0
                and self.last_fired_window is not None
                and self._fired_horizon(self.watermark)
                <= self.last_fired_window):
            # the watermark passed no new window end, and with lateness 0
            # pane expiry coincides with fires: nothing fires or expires, no
            # state is read, and the staged batches stay parked
            return []
        return self._advance_time(self.watermark)

    def prepare_snapshot_pre_barrier(self) -> List[StreamElement]:
        """Advance the staged batches and drain every pending async fire, so
        its rows travel downstream before the barrier; after this
        :meth:`snapshot_state` is legal, ``async_fire`` included."""
        self.flush_pipeline()
        if self.async_fire:
            return self.drain_pending_fires(force=True)
        return []

    def end_input(self) -> List[StreamElement]:
        """Bounded input: fire everything outstanding (and drain the async
        fires that this starts)."""
        out = self._advance_time(2 ** 62)
        if self.async_fire:
            out.extend(self.drain_pending_fires(force=True))
        return out

    def _advance_time(self, now: int) -> List[StreamElement]:
        self.flush_pipeline()       # fires and expiry below read state
        # async fires of earlier calls surface before any new ones
        out: List[StreamElement] = (self.drain_pending_fires()
                                    if self.async_fire else [])
        if self.pane_base is None or self._leaves is None:
            return out
        a = self.assigner
        w_max = self._fired_horizon(now)
        # bound firing to windows that can contain data
        lo_window = a.windows_of_pane(self.pane_base)[0]
        hi_window = a.windows_of_pane(self.max_pane)[1]
        start = (self.last_fired_window + 1
                 if self.last_fired_window is not None else lo_window)
        start = max(start, lo_window)
        for w in range(start, min(w_max, hi_window) + 1):
            out.extend(self._fire_window(w))
        if self.last_fired_window is None or w_max > self.last_fired_window:
            self.last_fired_window = w_max
        self._expire_panes(now)
        return out

    def _expire_panes(self, now: int):
        """Clear panes whose last window's cleanup time (max_ts + lateness)
        the watermark passed."""
        if self.pane_base is None:
            return
        expired = []
        p = self.pane_base
        while (p <= self.max_pane
               and self.assigner.last_window_end_of_pane(p) - 1
               + self.lateness <= now):
            expired.append(p)
            p += 1
        if not expired:
            return
        self.pane_base = p
        if self.device_sync_mode == "deferred":
            # no in-line device write: the next device_refresh rebuilds the
            # whole ring (identity where no live pane), subsuming this clear
            self._device_stale = True
        else:
            self._clear_panes_step(torch.from_numpy(
                np.asarray(expired, np.int64) % self._P).to(self.device))
        for ep in expired:
            self._mirror.pop(ep, None)
            self._vmirror.pop(ep, None)
            if self._nm is not None:
                self._nm.drop_pane(ep)
        if self._delta_counts is not None:
            # expired panes' unsynced delta is discarded with the mirror pane
            # it would have folded into
            dead = [q for q in expired if q in self._delta_panes]
            if dead:
                self._delta_clear_step(torch.from_numpy(
                    np.asarray(dead, np.int64) % self._P).to(self.device))
                self._delta_panes.difference_update(dead)
        if self.pane_base > self.max_pane:
            self.max_pane = self.pane_base

    # ------------------------------------------------------------------ fires
    def _fire_window(self, window_id: int) -> List[StreamElement]:
        if self._leaves is None:
            return []
        first, last = self.assigner.window_panes(window_id)
        if last < self.pane_base or first > self.max_pane:
            return []
        panes = np.arange(max(first, self.pane_base),
                          min(last, self.max_pane) + 1, dtype=np.int64)
        with self._phase("fire"):
            if self.emit_tier == "host":
                return self._fire_window_host(window_id, panes)
            return self._fire_window_gather(window_id, panes)

    def _fire_gather_step(self, pane_slots: torch.Tensor,
                          idx: torch.Tensor):
        """Fire for a host-known emit set: gather the ``idx`` key rows'
        window panes (``[n, len(panes)]`` cells of every leaf), combine the
        panes in JAX's pairwise order, ``get_result``."""
        cells = (idx.to(torch.int64).unsqueeze(1) * self._P
                 + pane_slots.unsqueeze(0))
        sel = tuple(l.view(-1).take(cells) for l in self._leaves)
        combined = combine_along_axis(sel, self.agg.combine_leaves, axis=1)
        return self.agg.get_result(self.spec.unflatten(combined))

    def _fire_window_gather(self, window_id: int,
                            panes: np.ndarray) -> List[StreamElement]:
        """Device-tier fire: the exact emit set from the host emit mirror,
        uploaded as int32; one gather step; one download of the result
        values (started here, collected now or, with ``async_fire``, by a
        later :meth:`drain_pending_fires`).  The keys resolve now."""
        idx = self._mirror_emit_idx(panes)
        if idx.size == 0:
            return []
        pane_slots = torch.from_numpy(panes % self._P).to(self.device)
        result = self._fire_gather_step(
            pane_slots, self._ids_to_device(idx.astype(np.int32)))
        handle = _fetch_enqueue(tree_leaves(result))
        keys = np.asarray(self.key_index.reverse_keys())[idx]
        pending = (window_id, keys, handle, tree_structure(result))
        if self.async_fire:
            self._pending_fires.append(pending)
            return []
        return self._finish_gather_fire(*pending)

    def drain_pending_fires(self, force: bool = False) -> List[StreamElement]:
        """Surface async fires IN ORDER, but only those whose downloads have
        completed (unless ``force``): waiting on one in flight would
        serialize it with the next batch's work.  More than 3 pending forces
        the drain, so memory stays bounded."""
        if not self._pending_fires:
            return []
        if len(self._pending_fires) > 3:
            force = True
        out: List[StreamElement] = []
        while self._pending_fires:
            if not force and not _handle_ready(self._pending_fires[0][2]):
                break
            out.extend(self._finish_gather_fire(*self._pending_fires.pop(0)))
        return out

    def _finish_gather_fire(self, window_id: int, keys: np.ndarray, handle,
                            structure) -> List[StreamElement]:
        fetched = _fetch_collect(handle)
        self.phase_bytes["d2h"] = (self.phase_bytes.get("d2h", 0)
                                   + sum(f.nbytes for f in fetched))
        return self._rows_for_keys(keys, tree_unflatten(structure, fetched),
                                   self.assigner.window_bounds(window_id))

    def _fire_window_host(self, window_id: int,
                          panes: np.ndarray) -> List[StreamElement]:
        """Serve a fire from the host mirror, after the bounded delta pull
        of exactly the panes about to fire."""
        self._devprobe_sync_mirror(panes)
        n = self.key_index.num_keys if self.key_index is not None else 0
        if n == 0:
            return []
        if self._nm is not None:
            # one C sweep: combine the panes, compact the non-empty rows in
            # ascending slot order, resolve their keys
            keys, _counts, leaves = self._nm.fire(panes)
            if keys.size == 0:
                return []
            result = self.agg.host_get_result(self.spec.unflatten(leaves))
            return self._rows_for_keys(keys, result,
                                       self.assigner.window_bounds(window_id))
        entries = [self._vmirror[int(p)] for p in panes.tolist()
                   if int(p) in self._vmirror]
        if not entries:
            return []
        total = entries[0][0][:n].copy()
        for e in entries[1:]:
            total += e[0][:n]
        idx = np.flatnonzero(total > 0)
        if idx.size == 0:
            return []
        acc_leaves = []
        for j, kind in enumerate(self.kinds):
            ufunc = SCATTER_UFUNCS[kind]
            leaf = entries[0][j + 1][idx]
            for e in entries[1:]:
                leaf = ufunc(leaf, e[j + 1][idx])
            acc_leaves.append(leaf)
        result = self.agg.host_get_result(self.spec.unflatten(acc_leaves))
        return self._rows_for(idx, result,
                              self.assigner.window_bounds(window_id))

    # -------------------------------------------------------------- snapshots
    def _leaf_schema(self) -> List[Dict[str, str]]:
        return [{"name": n, "dtype": np.dtype(d).name}
                for n, d in zip(self.spec.leaf_names, self.spec.leaf_dtypes)]

    def snapshot_state(self) -> Dict[str, Any]:
        """Dense numpy snapshot, served from the host mirror or, with
        ``snapshot_source="device"``, downloaded from the replica (the same
        format either way, and the JAX operator's)."""
        self.flush_pipeline()       # the snapshot must hold staged batches
        if self._pending_fires:
            # a snapshot with undrained async fires could neither replay nor
            # hold those emissions: the runtime drains them first
            raise ValueError(
                "snapshot with in-flight async fires: the runtime must call "
                "prepare_snapshot_pre_barrier() (and forward its elements) "
                "before snapshot_state()")
        snap: Dict[str, Any] = {
            "pane_base": self.pane_base,
            "max_pane": self.max_pane,
            "last_fired_window": self.last_fired_window,
            "watermark": self.watermark,
            "late_dropped": self.late_dropped,
            "P": self._P,
        }
        if self.key_index is not None:
            snap["key_index"] = self.key_index.snapshot()
            snap["key_index_kind"] = "KeyIndex"
        if self._leaves is not None and self.pane_base is not None \
                and self.key_index is not None:
            n = self.key_index.num_keys
            panes = np.arange(self.pane_base, self.max_pane + 1,
                              dtype=np.int64)
            snap["panes"] = panes
            with self._phase("snapshot"):
                if self.snapshot_source == "mirror":
                    counts, leaves = self._mirror_columns(panes.tolist(), n)
                else:
                    counts, leaves = self._device_columns(panes, n)
            snap["leaves"] = leaves
            snap["counts"] = counts
            snap["leaf_schema"] = self._leaf_schema()
        return snap

    def _device_columns(self, panes: np.ndarray, rows: int):
        """The replica's live columns: counts int32 ``[rows, len(panes)]``
        and one ``[rows, len(panes)]`` array per leaf, each downloaded in one
        gather (live keys x live panes)."""
        slots = torch.from_numpy(panes % self._P).to(self.device)
        leaves = [l[:rows].index_select(1, slots).cpu().numpy()
                  for l in self._leaves]
        counts = self._counts[:rows].index_select(1, slots).cpu().numpy()
        self.phase_bytes["d2h"] = (self.phase_bytes.get("d2h", 0)
                                   + counts.nbytes
                                   + sum(l.nbytes for l in leaves))
        return counts, leaves

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self.flush_pipeline()
        for unsupported, what in (("shard_slices", "sharding"),
                                  ("count_baselines", "count"),
                                  ("value_baselines", "count"),
                                  ("__increment__", "incremental")):
            if snap.get(unsupported):
                raise _later(what)
        self.pane_base = snap["pane_base"]
        self.max_pane = snap["max_pane"]
        self.last_fired_window = snap["last_fired_window"]
        self.watermark = snap["watermark"]
        self.late_dropped = snap.get("late_dropped", 0)
        self._P = snap["P"]
        self._dki = None         # probe table rebuilds from the key index
        self._drop_delta()
        self._devprobe_resolved = None
        self._nm = None          # rebinds to the restored key index below
        if "key_index" in snap:
            if snap["key_index_kind"] != "KeyIndex":
                raise _later("object_keys")
            self._bind_key_index(snap["key_index"])
            self._K = _next_pow2(max(self.key_index.num_keys, 1), self._K)
        else:
            self.key_index = None    # no keys yet: the next batch binds
        self._leaves = None
        self._counts = None
        self._vmirror = {}
        self._mirror = {}
        if "leaves" in snap:
            schema = snap.get("leaf_schema")
            if (schema is not None and list(schema) != self._leaf_schema()) \
                    or len(snap["leaves"]) != self.spec.num_leaves:
                raise _later("evolution")
            counts_np = np.asarray(snap["counts"])
            n = counts_np.shape[0]
            panes = np.asarray(snap["panes"], np.int64)
            restored = [np.asarray(l) for l in snap["leaves"]]
            # allocated either way, so time and fire guards see live state
            self._ensure_alloc()
            if self.device_sync_mode == "deferred":
                # the mirror (re-seeded below) is the authority: skip the
                # replica upload, device_refresh catches it up
                self._device_stale = True
            else:
                slots = torch.from_numpy(panes % self._P).to(self.device)
                for l, src in zip(self._leaves, restored):
                    l[:n, slots] = torch.from_numpy(
                        np.ascontiguousarray(src)).to(self.device, l.dtype)
                self._counts[:n, slots] = torch.from_numpy(
                    np.ascontiguousarray(counts_np, np.int32)).to(self.device)
            if self.emit_tier == "device":
                # rebuild the emit mirror from the snapshot's counts
                for j, p in enumerate(panes.tolist()):
                    nz = np.flatnonzero(counts_np[:, j] > 0)
                    if nz.size:
                        self._mirror_mark(int(p), nz)
                return
            # re-seed the value mirror from the snapshot (device precision —
            # the f64 surplus re-accumulates from here on)
            for j, p in enumerate(panes.tolist()):
                if not counts_np[:, j].any():
                    continue
                if self._nm is not None:
                    self._nm.import_pane(int(p), counts_np[:, j],
                                         [src[:, j] for src in restored])
                    continue
                entry = self._vmirror_pane(int(p))
                entry[0][:n] = counts_np[:, j]
                for k, src in enumerate(restored):
                    entry[k + 1][:n] = src[:, j].astype(
                        self._mirror_dtypes[k])

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
  counts), and under scatter sync into the replica too, both through the
  ordered fold (``csrc/scatter_fold.cu`` on the card, one call for both
  under scatter sync), so the ring is bit-equal to the CPU's; the host pass
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
  as in JAX; the fused lane concatenates the staged batches into one fold;
- **cold-key paging** (``paging=PagingConfig(...)``, device emit tier only,
  ``state/paging.py``): the ring is pinned at ``K_cap`` rows, a cache of
  the hot keys.  After the key lookup each batch's key ids map to ring
  rows; keys that do not fit page their live cells out to the spill store
  (one gather and download), and keys coming back page in (one upload and
  set).  A fire gathers the resident rows, then combines the spilled keys'
  uploaded cells in the same order; a snapshot merges both tiers into the
  dense gid-indexed format, and a restore at any capacity uploads the first
  ``K_cap`` keys and spills the rest.  Batches longer than ``K_cap / 2``
  split, and the super-batch depth resolves to 1;
- **the ``auto`` settings**, the JAX operator's defaults: the emit tier
  (``host`` on the card, ``device`` on the CPU), the snapshot source (the
  emit tier's), the sync cadence (the first host-tier batches time their
  own update steps, ``utils/transport.py``), the device probe
  (``calibrated_device_probe``), the super-batch depth
  (``superbatch=0``, ``calibrated_superbatch``) and the C pass's shard
  count (``native_shards=0``, ``calibrated_shards``), each measured once a
  process and resolved once per operator (the probe once per key index);
- **the two-stage pipeline** (``pipeline_depth=N > 0``): the hot stage of a
  batch (pane bookkeeping, the probe and mirror pass, paging, the device
  step) runs on one worker thread behind the task loop, in order, with at
  most N stages queued; every state read waits for it
  (:meth:`flush_pipeline`), so fires, snapshots and counters are the
  serial path's bit for bit.  On the card, the scatter lane's uploads go
  through reusable pinned buffers (:class:`_Staging`);
- **the device watchdog** (``runtime/device_health.py``): every hot-path
  dispatch (the replica fold, the probe step and its miss catch-up, the
  fused pass) runs on the process-wide monitor's lane thread under a
  deadline, behind a one-deep CUDA event fence (:meth:`_guarded`).  A
  wedge or exhausted retries quarantine the card: the operator moves to
  its host tier mid-job (the device tier downloads its ring into a host
  value mirror under a bounded salvage), an OOM on a paged operator forces
  a page-out and retries, and after a heal the state goes back on the card
  at the next ``prepare_snapshot_pre_barrier``;
- **sharded state** (``sharding=state_sharding(mesh)``, ``parallel/``):
  the ``[K, P]`` rings are kept as D row blocks ``[K/D, P]``, block ``d``
  on ``mesh.devices[d]`` (K rounded up to a multiple of D), reached through
  a few seams: :meth:`_row_blocks` for every whole-ring read or write
  (columns, clears, growth, refresh, restore), per-block versions of the
  hot writes, and the full-capacity fire :meth:`_fire_step` for the
  unpaged device tier, which keeps no emit mirror.  This class alone is
  JAX's placement-only operator (every block folds the rows of its range);
  ``parallel/mesh_runtime.MeshWindowAggOperator`` adds the record exchange,
  the sharded host tier, paging and degrade, and sliced snapshots.

Where JAX donated buffers to a jitted step, this port updates the same
tensors in place.  Batches are not padded: torch needs no static shapes, so
a step sees exactly the batch's rows, and the miss list is one
``torch.nonzero`` — the step's only host sync.  JAX's scoped ``enable_x64``
goes away: torch keeps f64 and i64 on the card.

JAX's device tier pads a fire's gather to a quantized width
(``_quantize_cap``) for static shapes; here it gathers exactly the emitted
rows.  JAX stages only on the host tier; here the device tier stages too
(one fold over the concatenated batches adds each cell's rows in the same
order as the per-batch folds, so the replica's bits are the same).

An aggregate with no scatter kinds (``LambdaReduce``, or any
``AggregateFunction`` whose ``scatter_kinds()`` is None) folds through
``ops/scatter.py`` ``scatter_generic`` (a stable sort, JAX's segmented
associative scan, one write per segment end, bit-equal to JAX's), on the
device tier, one batch at a time; its counts add with ``index_add_``.

**Count triggers** (``CountTrigger``, ``PurgingTrigger``, ``GlobalWindows``
with its ``NeverTrigger``) fire after each micro-batch from the device
counts, on the device tier, through the full-capacity fire
(:meth:`_fire_step`): GlobalWindows by key (:meth:`_fire_by_count`), a
purging trigger over tumbling windows by touched pane
(:meth:`_fire_count_in_panes`), and sliding windows or a non-purging
trigger through per-(key, window) count baselines, with value baselines
subtracted where a purge over sliding windows is logical
(:meth:`_fire_count_sliding`).  The baselines expire with their windows and
ride snapshots, rescales and restores.  Count triggers keep the hot path
serial (no pipeline, no super-batch), as in JAX.

**Object keys** (strings, bytes, tuples) take ``state/keyindex.py``
``ObjectKeyIndex`` with the numpy mirror and no device probe, as in JAX (the
C keydict and the probe table hold int64 keys); the fold of every lane still
runs on the card.  **Processing-time windows** (``TumblingProcessingTime
Windows``/``SlidingProcessingTimeWindows``) stamp each batch's records with
the clock seam's time (``utils/clock.py``), fire on the runtime's tick
(:meth:`on_processing_time`), and gate lateness on processing time.
**Late side outputs** (``late_output_tag``): records beyond the allowed
lateness leave as a :class:`TaggedBatch` on that tag, after the fires the
same call surfaces, on every lane (host and device tiers, ``async_fire``,
the super-batch, paging, the pipeline, the mesh), and ``late_dropped``
counts only what no side output takes, as in JAX.

**Incremental checkpoints** (``incremental_state``, set by the
MiniCluster): every mutation marks its ``(key, pane)`` cells or count/value
baseline windows dirty, as JAX's operator marks them, and a cut under
``snapshot_scope(cid, incremental=True)`` ships the union of the dirt of
every unconfirmed cut as a ``window_delta`` increment
(``runtime/checkpoint/delta.py`` resolves it), or a full re-base when there
is no confirmed base or the dirt exceeds ``incr_rebase_ratio`` of the grid.
The device tier downloads the dirty rows x dirty panes in one gather, so
the bytes follow the dirt, not the state.  The batch marks go in on the
caller's thread before the pipelined hot stage or the super-batch stage
takes the batch, so every lane marks the same cells.

``queryable=<name>`` publishes every fire's emitted ``(keys, values)``
arrays into a live-read view (``queryable/view.py``): the host arrays the
fire already made, so serving reads no device state.
"""

from __future__ import annotations

import contextlib
import math
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from flink_tpu_torch import DeviceLike, resolve_device
from flink_tpu_torch.core.batch import (LONG_MIN, RecordBatch, StreamElement,
                                        TaggedBatch, Watermark)
from flink_tpu_torch.core.functions import (SCATTER_UFUNCS, AggregateFunction,
                                            canonical_tensor, torch_dtype,
                                            tree_leaves, tree_structure,
                                            tree_unflatten)
from flink_tpu_torch.observability import tracing
from flink_tpu_torch.operators.base import (StreamOperator,
                                            current_checkpoint_id,
                                            snapshot_is_incremental)
from flink_tpu_torch.operators.fused_step import (MAX_STAGED_ROWS,
                                                  SuperBatchStage,
                                                  calibrated_super_shards,
                                                  calibrated_superbatch,
                                                  concat_staged)
from flink_tpu_torch.ops.scatter import (combine_along_axis,
                                         gather_row_pane_columns,
                                         ordered_fold_counts,
                                         ordered_fold_counts_multi,
                                         reset_rows, scatter_generic,
                                         segment_fold, set_row_pane_columns)
from flink_tpu_torch.ops.shapes import next_pow2 as _next_pow2
from flink_tpu_torch.runtime import device_health
from flink_tpu_torch.runtime.device_health import DeviceQuarantinedError
from flink_tpu_torch.state.device_keyindex import (DeviceKeyIndex,
                                                   calibrated_device_probe,
                                                   probe, probe_fold,
                                                   probe_fold_available)
from flink_tpu_torch.state.evolution import (acc_leaf_schema,
                                             migrate_acc_leaves)
from flink_tpu_torch.state.keyindex import (KeyIndex, NativeKeyIndex,
                                            ObjectKeyIndex, key_index_kind,
                                            restore_key_index)
from flink_tpu_torch.state.native_mirror import (NativeWindowMirror,
                                                 calibrated_shards, ineligible)
from flink_tpu_torch.state.paging import DevicePager, identity_grid
from flink_tpu_torch.state.redistribute import (merge_keyed_snapshots,
                                                split_keyed_snapshot)
from flink_tpu_torch.state.shard_layout import densify_keyed_snapshot
from flink_tpu_torch.utils import clock, transport
from flink_tpu_torch.windowing.assigners import GlobalWindows, WindowAssigner
from flink_tpu_torch.windowing.triggers import (EventTimeTrigger, NeverTrigger,
                                                Trigger)

#: options of the JAX operator that the port still refuses (none left)
_LATER: Dict[str, str] = {}


def _add_counts(flat_counts: torch.Tensor, ids: torch.Tensor,
                cells: int) -> None:
    """``flat_counts[id] += 1`` per row, in place, ids outside ``[0,
    cells)`` dropped (the generic fold's counts: an integer sum, the same in
    any order; no host sync)."""
    keep = (ids >= 0) & (ids < cells)
    flat_counts.index_add_(0, torch.where(keep, ids, 0).to(torch.int64),
                           keep.to(flat_counts.dtype))


def _distinct_ids(parts) -> np.ndarray:
    """``np.unique`` of the concatenated non-negative int64 id arrays
    ``parts`` (sorted, distinct), through a bitmap when the ids are dense
    (the delta checkpoints' key-id sets: a sort of 10^5-10^6 ids costs
    tens of ms on the host, the bitmap a pass over it)."""
    ids = parts[0] if len(parts) == 1 else np.concatenate(parts)
    ids = np.asarray(ids, np.int64)
    if ids.size == 0:
        return ids.copy()
    top = int(ids.max()) + 1
    if top > 8 * ids.size + 4096:
        return np.unique(ids)
    seen = np.zeros(top, bool)
    seen[ids] = True
    return np.flatnonzero(seen).astype(np.int64, copy=False)


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


class _HotPipeline:
    """One background worker running hot-path stages IN ORDER.

    The two-stage pipeline of :meth:`WindowAggOperator.process_batch`: the
    hot stage of batch N (probe and mirror pass, paging, device step) runs
    here while the task thread returns to its loop for batch N+1.  One
    worker, so stages run strictly one after another and mutate state in
    the serial path's order; only the thread changes.  ``depth`` bounds the
    QUEUE: ``submit`` blocks once ``depth`` stages wait, so at most
    ``depth + 1`` batches are held (queued plus running).

    Each stage runs with the operator's card as the thread's current CUDA
    device (the current device is per host thread), on the thread's default
    stream, which is the task thread's too (the legacy default stream), so
    the stages' launches and the task thread's are ordered on one stream.

    Errors are sticky: a stage error parks the worker (later stages are
    skipped) and re-raises at EVERY later ``flush()``/``submit()``, a CUDA
    error raised in a stage included, so a monitoring caller cannot consume
    the failure the task thread's own next barrier must see.  Only
    ``close()`` clears it.
    """

    __slots__ = ("depth", "device", "_q", "_err", "_t")

    def __init__(self, depth: int, device: torch.device):
        self.depth = max(1, int(depth))
        self.device = device
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._err: Optional[BaseException] = None
        self._t: Optional[threading.Thread] = None

    def _loop(self) -> None:
        while True:
            fn = self._q.get()
            try:
                if fn is None:
                    return
                if self._err is None:
                    if self.device.type == "cuda":
                        with torch.cuda.device(self.device):
                            fn()
                    else:
                        fn()
            except BaseException as e:  # noqa: BLE001 — re-raised at flush
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, fn) -> None:
        if self._err is not None:
            self.flush()
        if self._t is None:
            self._t = threading.Thread(target=self._loop, daemon=True,
                                       name="winagg-pipeline")
            self._t.start()
        self._q.put(fn)  # blocks at depth: the bounded pipeline

    def pending(self) -> bool:
        return self._q.unfinished_tasks > 0

    def flush(self) -> None:
        """Barrier: block until every submitted stage completed.  A parked
        stage error re-raises here and STAYS parked."""
        if self._t is not None:
            self._q.join()
        if self._err is not None:
            raise self._err

    def close(self) -> None:
        self._err = None
        if self._t is not None:
            self._q.put(None)
            self._t.join(timeout=10)
            self._t = None


class _Staging:
    """One reusable upload set of the scatter lane: the flat ids and one
    buffer per value leaf, ``rows`` long (a power of two of at least 64;
    a batch fills a prefix).  On the card the buffers are pinned and feed
    ``non_blocking`` copies; ``token`` is a CUDA event recorded after the
    launches that consumed them, and the set is free again once it has
    completed.  On the CPU the buffers are plain, the fold reads them
    before the call returns, and ``token`` stays None."""

    __slots__ = ("flat", "bufs", "token")

    def __init__(self, rows: int, flat_dtype, leaves, pin: bool):
        def empty(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=pin)
        self.flat = empty((rows,), torch_dtype(flat_dtype))
        self.bufs = [empty((rows,) + a.shape[1:], torch_dtype(a.dtype))
                     for a in leaves]
        self.token = None

    def ready(self) -> bool:
        return self.token is None or bool(self.token.query())

    def fill(self, flat: Optional[np.ndarray], leaves, B: int):
        """Copy the batch into the set; returns the host tensors of its
        ``B`` rows (the flat ids, then the leaves).  ``flat`` None: the C
        pass already wrote the ids into :meth:`flat_out`."""
        if flat is not None:
            self.flat.numpy()[:B] = flat
        for buf, a in zip(self.bufs, leaves):
            buf.numpy()[:B] = a
        return self.flat[:B], [buf[:B] for buf in self.bufs]

    def flat_out(self, B: int) -> np.ndarray:
        """The ids buffer's first ``B`` rows as numpy, for the C pass."""
        return self.flat.numpy()[:B]


class _EventSet:
    """The fence of a dispatch that launched on several cards: one CUDA
    event per card, with an event's ``query``/``synchronize``."""

    __slots__ = ("events",)

    def __init__(self, events):
        self.events = tuple(events)

    def query(self) -> bool:
        return all(e.query() for e in self.events)

    def synchronize(self) -> None:
        for e in self.events:
            e.synchronize()


class _PhaseTimer:
    """Accumulates host wall time into a dict entry (phase breakdown).
    When the span journal is installed, each timed region also records a
    ``hot_stage`` span named by the phase, of the same duration."""

    __slots__ = ("_d", "_k", "_t0")

    def __init__(self, d: Dict[str, int], key: str):
        self._d = d
        self._k = key

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._d[self._k] = self._d.get(self._k, 0) + t1 - self._t0
        j = tracing._JOURNAL       # one attribute read and a None check off
        if j is not None:
            j.record("X", self._t0, t1 - self._t0, self._k, "hot_stage")
        return False


class WindowAggOperator(StreamOperator):
    """Keyed window aggregation: ``key_by(key_col).window(assigner).aggregate(agg)``.

    The constructor takes the JAX operator's parameter names, so one set of
    keyword arguments builds either; ``max_batch`` is accepted and unused
    (as it is there), ``device`` is the port's own."""

    #: sharded-state capabilities, overridden by the mesh subclass: with
    #: ``sharding`` set this class is placement only (no host tier, no
    #: paging, no degrade); the mesh operator runs all three per shard
    _SHARDED_HOST_TIER = False
    _SHARDED_PAGING = False
    _SHARDED_DEGRADE = False
    #: the one-step lane over a super-batch (:meth:`_fused_flush_scan`);
    #: the mesh stages through the concatenated host pass instead
    _FUSED_SCAN = True
    #: the row fields of a keyed snapshot (rescale split and merge)
    ROW_FIELDS = ("leaves", "counts")

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
        emit_tier: str = "auto",
        snapshot_source: str = "auto",
        native_emit: bool = True,
        device_sync: str = "auto",
        paging=None,
        pipeline_depth: int = 0,
        native_shards: int = 0,
        device_probe: str = "auto",
        queryable: Optional[str] = None,
        superbatch: int = 1,
        device: DeviceLike = None,
    ):
        if trigger is None:
            # GlobalWindows defaults to NeverTrigger (GlobalWindows.java
            # getDefaultTrigger), time windows to EventTimeTrigger
            trigger = (NeverTrigger() if isinstance(assigner, GlobalWindows)
                       else EventTimeTrigger())
        if trigger.fires_on_count and not isinstance(assigner, GlobalWindows) \
                and assigner.panes_per_window != 1 \
                and trigger.purges_on_fire \
                and not agg.supports_retraction():
            raise NotImplementedError(
                "PURGING count triggers over MULTI-PANE (sliding) assigners "
                "need an INVERTIBLE aggregate (all-'add' ACC leaves: "
                "sum/count/avg): overlapping windows share panes, so the "
                "purge is logical — a per-(key, window) value baseline is "
                "subtracted instead of clearing shared cells.  Min/max "
                "cannot retract; use a plain CountTrigger (fire without "
                "purge) for those.")
        self.trigger = trigger
        if int(pipeline_depth) < 0:
            raise ValueError("pipeline_depth must be >= 0")
        if paging is not None:
            # the JAX operator's checks, before this slice's refusals: the
            # same configurations raise the same ValueErrors
            if sharding is not None and not self._SHARDED_PAGING:
                raise ValueError("paging requires unsharded state (shard "
                                 "first, page within each shard)")
            if isinstance(assigner, GlobalWindows) \
                    or trigger.fires_on_count or not trigger.fires_on_time:
                raise ValueError("paging requires time-triggered time "
                                 "windows (no count triggers/GlobalWindows)")
            if emit_tier == "auto":
                emit_tier = "device"
            if emit_tier != "device":
                raise ValueError("paging pins the device emit tier (the "
                                 "host mirror is unbounded host state)")
        if sharding is not None:
            # sharded state lives on the mesh; the operator's own device
            # (the probe table, uploads before routing) is position 0
            home = sharding.mesh.devices[0]
            if device is not None and resolve_device(device) != home:
                raise ValueError(f"device={device!r} but the mesh starts at "
                                 f"{home}")
            device = home
        self.device = resolve_device(device)
        # ---- the emit tier: "auto" picks the host value mirror exactly
        # when the aggregate has numpy twins, fires are time-triggered and
        # the state lives on a card (on the CPU there is no transfer to
        # save), as JAX picks it off ``jax.default_backend()``
        host_capable = (agg.supports_host_emit() and trigger.fires_on_time
                        and not trigger.fires_on_count
                        and not isinstance(assigner, GlobalWindows)
                        and (sharding is None or self._SHARDED_HOST_TIER))
        if emit_tier == "auto":
            emit_tier = ("host" if host_capable and self.device.type != "cpu"
                         else "device")
        if emit_tier not in ("host", "device"):
            raise ValueError(f"emit_tier must be auto|host|device, got "
                             f"{emit_tier!r}")
        if emit_tier == "host" and not host_capable:
            raise ValueError(
                "emit_tier='host' requires an unsharded, time-triggered "
                "window over an aggregate with numpy twins "
                "(AggregateFunction.supports_host_emit)")
        # snapshots follow the emit tier under "auto"
        if snapshot_source == "auto":
            snapshot_source = "mirror" if emit_tier == "host" else "device"
        if snapshot_source not in ("mirror", "device"):
            raise ValueError(f"snapshot_source must be auto|mirror|device, "
                             f"got {snapshot_source!r}")
        if snapshot_source == "mirror" and emit_tier != "host":
            raise ValueError("snapshot_source='mirror' requires the host "
                             "emit tier")
        if device_sync not in ("auto", "scatter", "deferred"):
            raise ValueError(f"device_sync must be auto|scatter|deferred, "
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
        if device_probe not in ("auto", "on", "off"):
            raise ValueError(f"device_probe must be auto|on|off, "
                             f"got {device_probe!r}")
        if int(superbatch) < 0:
            raise ValueError("superbatch must be >= 0 (0 = auto)")
        if int(native_shards) < 0:
            raise ValueError(f"native_shards must be >= 0 (0 = auto), got "
                             f"{native_shards!r}")
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
        #: sideOutputLateData: beyond-lateness records ship as a TaggedBatch
        #: on this tag instead of being dropped (and not counted)
        self.late_output_tag = late_output_tag
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
        #: the replica's sync cadence as asked ("auto" | "scatter" |
        #: "deferred") and as resolved on the first batch or restore
        #: (``device_sync_mode``: "scatter" | "deferred"; None until then)
        self.device_sync = device_sync
        self.device_sync_mode: Optional[str] = None
        #: auto sync: calibrating batches so far (at most 8: batches too
        #: small to give a sample settle on scatter)
        self._calib_batches = 0
        #: deferred sync: the replica lags the mirror until device_refresh
        self._device_stale = False
        #: two-stage pipeline depth (0 = serial) and its worker
        self.pipeline_depth = int(pipeline_depth)
        self._pipe: Optional[_HotPipeline] = None
        #: reusable upload sets of the scatter lane, by (rows, id dtype,
        #: value leaves' dtypes and shapes)
        self._staging_pool: Dict[tuple, List[_Staging]] = {}
        #: fused lane: staging depth as asked (1 = off, 0 = auto) and as
        #: resolved on the first resolved batch (1 under paging, as JAX's
        #: ``_fused_depth``), the stage and counters
        self.superbatch = int(superbatch)
        self._fused_resolved: Optional[int] = None
        self._fused_shards = 0   # super-pass C shard count (0 = unresolved)
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
        #: the C host layer: keydict + WinMirror, bound per key index (an
        #: accumulator the C mirror cannot hold keeps the numpy mirror, as
        #: in JAX); its pass's shard count (0 = measured, on binding)
        self.native_emit = bool(native_emit)
        self.native_shards = int(native_shards)
        self._nm_shards = 1
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
        #: per-shard phase ns: phase -> int64 [shards], filled when the C
        #: pass runs sharded with a timing buffer (the mesh's per-shard
        #: probe breakdown; empty otherwise)
        self.phase_shard_ns: Dict[str, np.ndarray] = {}

        # ring geometry — P must exceed the live pane span
        self._P = _next_pow2(max(initial_panes, 2 * assigner.panes_per_window))
        # paged: K_cap is the FIXED resident capacity — the ring never grows
        # with key cardinality; cold keys page out instead
        self._K = _next_pow2(paging.capacity if paging is not None
                             else initial_key_capacity)
        #: the placement of the state (None: one ring on ``device``)
        self.sharding = sharding
        if sharding is not None:
            # even blocks: K rounds up to lcm(K, D); doubling keeps it
            nsh = sharding.mesh.size
            self._K = self._K * nsh // math.gcd(self._K, nsh)
        #: cold-key paging (``state/paging.py``): the ring is a cache of the
        #: hot keys' rows, and the device tier's slots are ring rows
        self._pager: Optional[DevicePager] = (
            DevicePager(paging, self.spec, self._K) if paging is not None
            else None)
        self.key_index = None   # KeyIndex, NativeKeyIndex or ObjectKeyIndex
        self._leaves = None          # tuple of [K, P, *leaf] device tensors
        self._counts = None          # int32 [K, P]
        #: count triggers: window id -> int64 [<=K] count already fired per
        #: key slot (the CountTrigger count register, which clears on FIRE:
        #: the next fire needs n MORE elements)
        self._count_baselines: Dict[int, np.ndarray] = {}
        #: purging count triggers over sliding windows: window id -> the
        #: fired-so-far accumulator per leaf (leaf dtypes), subtracted from
        #: the live pane combine (a logical purge: overlapping windows share
        #: the pane cells)
        self._value_baselines: Dict[int, List[np.ndarray]] = {}
        self.pane_base: Optional[int] = None   # smallest retained pane id
        self.max_pane: Optional[int] = None    # largest pane seen
        self.last_fired_window: Optional[int] = None
        self.watermark: int = LONG_MIN
        self.late_dropped: int = 0
        #: processing time as the runtime last ticked it (monotone)
        self._proc_time: int = LONG_MIN

        # ---- device-resident key probe lane
        self._dki: Optional[DeviceKeyIndex] = None
        self._devprobe_resolved: Optional[bool] = None
        self._delta_leaves = None             # mirror-dtype [K, P] tensors
        self._delta_counts = None             # int32 [K, P]
        self._delta_panes: set = set()        # panes with unsynced delta
        self._dp_stats = {"probe_hits": 0, "probe_misses": 0,
                          "miss_inserts": 0, "delta_syncs": 0}

        # ---- device-lane health (runtime/device_health.py): every hot-path
        # dispatch runs under the process-wide watchdog.  ``_degraded`` is
        # True while this operator runs on its host tier after the monitor
        # quarantined the card: the host tier just stops dispatching (its
        # mirror is the authority), the device tier materializes its pane
        # ring into the host value mirror and serves fires and snapshots
        # from it until re-promotion at a checkpoint-aligned safe point
        self._degraded = False
        self._quarantine_migrations = 0
        self._repromotions = 0
        #: tier-transition fencing: every degrade or abandoned promotion
        #: bumps the epoch; a re-promotion commits, and a guarded dispatch
        #: writes, only under the epoch it started with
        self._tier_epoch = 0
        self._tier_lock = threading.Lock()
        #: guarded hot-path dispatches (``fused_stats()["hot_dispatches"]``)
        self._hot_dispatches = 0
        #: the geometry of each dispatch site's last guarded dispatch
        self._dispatch_geoms: Dict[str, tuple] = {}
        #: the CUDA event recorded after the last guarded dispatch's
        #: launches: the next guarded dispatch waits on it under its own
        #: deadline (the one-deep event fence)
        self._fence = None
        #: True from a guarded dispatch's first in-place write until it
        #: returns (in-place state has no donated buffers to test): left set
        #: by an attempt that died or was abandoned mid-write
        self._writing = False
        #: paged: the ring rows of the batch in flight, protected from the
        #: OOM page-out
        self._active_rows = None

        # ---- queryable serving: when named, every fire's emitted (keys,
        # values) arrays publish into a live-read view, tagged with the
        # watermark and the last completed checkpoint; None costs one
        # attribute check a fire
        self.queryable = queryable
        self._qview = None
        self._last_completed_checkpoint: Optional[int] = None
        if queryable is not None:
            from flink_tpu_torch.queryable.view import WindowReadView
            self._qview = WindowReadView(key_column)

        # ---- incremental (delta) checkpoints: the runtime turns them on;
        # off, they cost one attribute check a batch
        self.incremental_state = False
        #: a full re-base when the dirty cells exceed this share of the grid
        self.incr_rebase_ratio = 0.5
        self._incr_clear()

    # ------------------------------------------------------------------ state
    def _alloc(self, K: int, P: int):
        return self._new_ring(K, P, self.spec.leaf_inits,
                              self.spec.leaf_dtypes, self.spec.leaf_shapes)

    def _state_devices(self) -> List[torch.device]:
        """Each device that holds state, once."""
        return ([self.device] if self.sharding is None
                else self.sharding.mesh.distinct_devices())

    def _new_ring(self, K: int, P: int, inits, dtypes, shapes):
        """A fresh ``[K, P, *shape]`` ring per leaf (at its identity) and an
        int32 ``[K, P]`` count ring; with sharded state each is a list of D
        ``[K/D, P]`` row blocks, block ``d`` on the mesh's ``d``-th device
        (then ``leaves[j][d]`` is leaf ``j``'s block ``d``)."""
        def ring(shape, fill, dtype, rows, dev):
            return torch.full((rows, P) + tuple(shape), fill,
                              dtype=torch_dtype(dtype), device=dev)
        if self.sharding is None:
            return (tuple(ring(shape, np.asarray(init).item(), dtype, K,
                               self.device)
                          for init, shape, dtype in zip(inits, shapes,
                                                        dtypes)),
                    ring((), 0, np.int32, K, self.device))
        devices = self.sharding.mesh.devices
        kd = K // len(devices)
        return (tuple([ring(shape, np.asarray(init).item(), dtype, kd, dev)
                       for dev in devices]
                      for init, shape, dtype in zip(inits, shapes, dtypes)),
                [ring((), 0, np.int32, kd, dev) for dev in devices])

    @staticmethod
    def _row_blocks(leaves, counts) -> list:
        """(first row, leaf blocks, count block) of each row block of a
        ring: the ring itself, or one block per mesh position when the
        state is sharded."""
        if not isinstance(counts, list):
            return [(0, tuple(leaves), counts)]
        kd = counts[0].shape[0]
        return [(d * kd, tuple(l[d] for l in leaves), c)
                for d, c in enumerate(counts)]

    @staticmethod
    def _ring_shape(counts) -> tuple:
        """(K, P) of a ring (K: the rows of every block)."""
        if isinstance(counts, list):
            return sum(c.shape[0] for c in counts), counts[0].shape[1]
        return tuple(counts.shape)

    @staticmethod
    def _on_device(dev: torch.device):
        """``dev`` as the calling thread's current CUDA device (a no-op on
        the CPU)."""
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())

    def _ring_columns(self, leaves, counts, pane_slots: np.ndarray,
                      rows: int):
        """Download columns ``pane_slots`` of a ring's first ``rows`` rows:
        counts ``[rows, m]`` and one ``[rows, m, *leaf]`` array per leaf,
        block by block."""
        cnt, lvs = [], [[] for _ in leaves]
        for lo, lb, cb in self._row_blocks(leaves, counts):
            r = min(cb.shape[0], rows - lo)
            if r <= 0 and cnt:
                break
            s = torch.from_numpy(np.asarray(pane_slots, np.int64)).to(
                cb.device)
            cnt.append(cb[:max(r, 0)].index_select(1, s).cpu().numpy())
            for acc, l in zip(lvs, lb):
                acc.append(l[:max(r, 0)].index_select(1, s).cpu().numpy())

        def cat(parts):
            return parts[0] if len(parts) == 1 else np.concatenate(parts)
        return cat(cnt), [cat(p) for p in lvs]

    def _set_columns(self, leaves, counts, pane_slots: np.ndarray,
                     counts_np: np.ndarray, leaves_np) -> None:
        """Set columns ``pane_slots`` of a ring's first ``counts_np.shape[0]``
        rows from dense host columns (counts ``[rows, m]``; each leaf's
        first rows), in place, block by block."""
        rows = counts_np.shape[0]
        for lo, lb, cb in self._row_blocks(leaves, counts):
            r = min(cb.shape[0], rows - lo)
            if r <= 0:
                break
            s = torch.from_numpy(np.asarray(pane_slots, np.int64)).to(
                cb.device)
            for l, src in zip(lb, leaves_np):
                l[:r, s] = torch.from_numpy(
                    np.ascontiguousarray(src[lo:lo + r])).to(cb.device,
                                                            l.dtype)
            cb[:r, s] = torch.from_numpy(
                np.ascontiguousarray(counts_np[lo:lo + r], np.int32)).to(
                    cb.device)

    def _clear_columns(self, leaves, counts, pane_slots: torch.Tensor,
                       inits) -> None:
        """Reset ring columns ``pane_slots`` to identity, in place."""
        for _, lb, cb in self._row_blocks(leaves, counts):
            s = pane_slots.to(cb.device)
            for l, init in zip(lb, inits):
                l[:, s] = init
            cb[:, s] = 0

    def _copy_rows(self, src_leaves, src_counts, dst_leaves,
                   dst_counts) -> None:
        """Copy every row of a ring into the same global rows of a larger
        one (key growth: with sharded state the block boundaries move)."""
        src = self._row_blocks(src_leaves, src_counts)
        for dlo, dl, dc in self._row_blocks(dst_leaves, dst_counts):
            for slo, sl, sc in src:
                a = max(dlo, slo)
                b = min(dlo + dc.shape[0], slo + sc.shape[0])
                if a >= b:
                    continue
                for f, o in zip(dl, sl):
                    f[a - dlo:b - dlo] = o[a - slo:b - slo].to(dc.device)
                dc[a - dlo:b - dlo] = sc[a - slo:b - slo].to(dc.device)

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

    def _bind_key_index(self, snap=None, kind: str = "KeyIndex",
                        object_keys: bool = False) -> None:
        """A fresh key index (restored from ``snap`` of ``kind`` if given)
        and, with native_emit on the host tier, the C mirror sharing its
        keydict (the device tier binds the keydict alone, as JAX does).
        Object keys take an :class:`ObjectKeyIndex` and keep the numpy
        mirror: the C keydict holds int64 keys only (JAX's
        ``_try_native_mirror``).  The old mirror is dropped first: it pins
        the old keydict, never the new one."""
        self._nm = None
        if snap is not None and kind == "ObjectKeyIndex":
            self.key_index = restore_key_index(snap, kind)
            return
        if snap is None and object_keys:
            self.key_index = ObjectKeyIndex()
            return
        cls = NativeKeyIndex if self.native_emit else KeyIndex
        self.key_index = (cls.restore(snap) if snap is not None else
                          cls(initial_capacity=max(1 << 16, 2 * self._K)))
        if (self.native_emit and self.emit_tier == "host"
                and ineligible(self.spec, self.kinds,
                               self._mirror_dtypes) is None):
            self._nm = NativeWindowMirror.create(
                self.key_index, self.spec, self.kinds, self._mirror_dtypes)
            # 0 = auto: measured once a process (calibrated_shards)
            self._nm_shards = self.native_shards or calibrated_shards()

    def _native_probe_update(self, keys, panes, values, flat_out=None,
                             super_pass: bool = False):
        """The C pass over a block of rows: key inserts (numbered by first
        occurrence) and the mirror fold; with ``flat_out`` also the device
        scatter ids ``slot * P + pane % P``.  Returns the rows' slots.  Its
        shards are the per-batch ones (:meth:`_probe_shards`), or a
        super-batch's (``super_pass``); per-shard wall times, where the
        shards report them, add to ``phase_shard_ns["probe_mirror"]``."""
        lifted = [np.asarray(l)
                  for l in tree_leaves(self.agg.host_lift(values))]
        shards, shard_div, shard_ns = (self._fused_super_shards()
                                       if super_pass
                                       else self._probe_shards())
        slots = self._nm.probe_update(
            keys, panes, lifted,
            pane_mod=self._P if flat_out is not None else 0,
            flat_out=flat_out, shards=shards, shard_div=shard_div,
            shard_ns=shard_ns)
        self._record_shard_ns("probe_mirror", shard_ns)
        return slots

    def _probe_shards(self):
        """(shards, shard_div, shard_ns) of the C pass: the shard count, the
        contiguous-range ownership divisor (0: ``slot % shards`` classes)
        and an optional int64 per-shard timing buffer.  The mesh aligns
        them with its blocks."""
        return self._nm_shards, 0, None

    def _record_shard_ns(self, phase: str, shard_ns) -> None:
        if shard_ns is None:
            return
        acc = self.phase_shard_ns.get(phase)
        if acc is None or acc.size < shard_ns.size:
            grown = np.zeros(shard_ns.size, np.int64)
            if acc is not None:
                grown[:acc.size] = acc
            acc = self.phase_shard_ns[phase] = grown
        acc[:shard_ns.size] += shard_ns

    def reset_state(self) -> None:
        """Drop all keyed state and time progress (the key index, its C
        mirror, the device state, the probe table, the stage, the pager's
        residency and spill tier, and the counters); the configuration and
        the resolved sync cadence and super-batch depth stay.  In-flight
        pipeline stages complete first (they still write this state).  The
        next batch binds a fresh key index and mirror."""
        if self._pipe is not None:
            self._pipe.flush()
        self._fused_stage.take()
        self.key_index = None
        self._nm = None          # its keydict dies with the key index
        self._leaves = None
        self._counts = None
        self._count_baselines = {}
        self._value_baselines = {}
        self._vmirror = {}
        self._mirror = {}
        self._pending_fires = []
        self.pane_base = None
        self.max_pane = None
        self.last_fired_window = None
        self.watermark = LONG_MIN
        self.late_dropped = 0
        self._proc_time = LONG_MIN
        self.phase_ns = {}
        self.phase_bytes = {}
        self.phase_shard_ns = {}
        self._fused_counters = {k: 0 for k in self._fused_counters}
        self._hot_dispatches = 0
        self._device_stale = False
        self._degraded = False      # fresh state starts on the device
        self._cut_dispatches()
        self._active_rows = None
        self._writing = False
        self._dki = None
        self._drop_delta()
        self._devprobe_resolved = None
        self._dp_stats = {k: 0 for k in self._dp_stats}
        self._incr_clear()      # a fresh state has no confirmed delta base
        if self._pager is not None:
            self._pager.reset()

    def close(self) -> None:
        """Complete the pipeline and advance the staged batches, then stop
        the pipeline's worker and release the pager's spill store.  A
        parked stage error re-raises here once more, and is then
        cleared."""
        try:
            self.flush_pipeline()
        finally:
            if self._pipe is not None:
                self._pipe.close()
                self._pipe = None
            if self._pager is not None:
                self._pager.close()

    # ----------------------------------------------- device-resident probe
    def _devprobe_eligible(self) -> bool:
        """Static eligibility, as JAX's: not "off", the host emit tier,
        integer keys (the probe table holds int64 keys), scalar
        add/min/max accumulator leaves (the delta fold contract) and no
        paging (the pager needs every record's key id on the host)."""
        return (self.device_probe != "off"
                and self.emit_tier == "host"
                and self._pager is None
                and self.kinds is not None
                and all(tuple(s) == () for s in self.spec.leaf_shapes)
                and not isinstance(self.key_index, ObjectKeyIndex)
                and not self.trigger.fires_on_count)

    def _devprobe_active(self, sync: str) -> bool:
        """The probe lane's gate for a batch under the resolved ``sync``:
        off while the sync cadence calibrates; otherwise resolved once per
        key-index lifetime ("on" forces, "auto" asks the measured
        :func:`calibrated_device_probe`).  Off while the tier is degraded."""
        if self._degraded or sync not in ("scatter", "deferred"):
            return False
        if self._devprobe_resolved is None:
            if not self._devprobe_eligible():
                self._devprobe_resolved = False
            elif self.device_probe == "on":
                self._devprobe_resolved = True
            else:
                self._devprobe_resolved = calibrated_device_probe(
                    self.device)
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
                and self._ring_shape(self._delta_counts) == (self._K,
                                                             self._P):
            return
        self._delta_leaves, self._delta_counts = self._new_ring(
            self._K, self._P,
            [np.asarray(init).astype(mdt)
             for init, mdt in zip(self.spec.leaf_inits, self._mirror_dtypes)],
            self._mirror_dtypes, [()] * self.spec.num_leaves)
        self._delta_panes = set()

    def _flat_state(self, leaves, counts):
        K, P = counts.shape
        return (tuple(l.view((K * P,) + tuple(l.shape[2:])) for l in leaves),
                counts.view(K * P))

    def _probed_update_step(self, buckets, keys, pane_slots, values):
        """One micro-batch with the key probe on the card: probe the table
        with the int64 keys and list the miss rows (int64, ascending; the
        step's one host sync).  Returns the write: one ordered fold of the
        hit rows into the device replica (device precision) and the delta
        ring (mirror precision), in place, in row order; miss rows carry the
        dropped id K*P.  The write returns the miss rows."""
        slot = probe(buckets, keys)
        hit = slot >= 0
        K, P = self._counts.shape
        flat = torch.where(hit, slot.to(torch.int64) * P + pane_slots, K * P)
        lifted = tuple(tree_leaves(self.agg.lift(values)))
        miss = torch.nonzero(~hit).squeeze(1)

        def write():
            ordered_fold_counts_multi(
                ((*self._flat_state(self._leaves, self._counts), lifted),
                 (*self._flat_state(self._delta_leaves, self._delta_counts),
                  lifted)), flat, self.kinds)
            return miss
        return write

    def _probed_delta_step(self, buckets, keys, pane_slots, values):
        """Deferred-sync twin of :meth:`_probed_update_step`: the mirror is
        the authority, so the write folds hit rows into the delta ring only,
        in row order (the replica catches up at :meth:`device_refresh`)."""
        slot = probe(buckets, keys)
        hit = slot >= 0
        K, P = self._delta_counts.shape
        flat = torch.where(hit, slot.to(torch.int64) * P + pane_slots, K * P)
        lifted = tuple(tree_leaves(self.agg.lift(values)))
        miss = torch.nonzero(~hit).squeeze(1)

        def write():
            ordered_fold_counts(*self._flat_state(self._delta_leaves,
                                                  self._delta_counts),
                                flat, lifted, self.kinds)
            return miss
        return write

    def _fused_scan_delta_step(self, buckets, keys, pane_slots, values):
        """Deferred-sync step of the fused lane over a whole super-batch:
        the write is ONE ``probe_fold`` launch that probes every row and
        folds the hit rows into the delta ring in row order, then lists the
        miss rows (int64, ascending).  Where :func:`probe_fold_available`
        says no (not a single ``add`` leaf), the block takes
        :meth:`_probed_delta_step`, as JAX's scan body takes probe + scatter
        when its Pallas gate says no."""
        if not probe_fold_available(self.kinds, self._delta_leaves[0].dtype):
            return self._probed_delta_step(buckets, keys, pane_slots,
                                           values)
        (dsum,), dcnt = self._flat_state(self._delta_leaves,
                                         self._delta_counts)
        (vals,) = tree_leaves(self.agg.lift(values))

        def write():
            slot, _, _ = probe_fold(buckets, keys, pane_slots, keys.shape[0],
                                    vals, dsum, dcnt, self._P)
            return torch.nonzero(slot < 0).squeeze(1)
        return write

    def _delta_clear_step(self, pane_slots: torch.Tensor) -> None:
        """Reset synced (or expired) delta columns to identity, in place."""
        self._clear_columns(
            self._delta_leaves, self._delta_counts, pane_slots,
            [np.asarray(init).astype(mdt).item()
             for init, mdt in zip(self.spec.leaf_inits, self._mirror_dtypes)])

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
            slots_np = np.asarray([p % self._P for p in sync], np.int64)
            cnt_np, sel_np = self._ring_columns(
                self._delta_leaves, self._delta_counts, slots_np, n)
            self._delta_clear_step(torch.from_numpy(slots_np).to(self.device))
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
                initial_capacity=max(1 << 16, 2 * self._K),
                device=self._devprobe_table_sharding() or self.device)
        self._dki.ensure_loaded(self.key_index)   # bulk/restore load

    def _devprobe_table_sharding(self):
        """Placement of the device probe table (None: the operator's
        device).  The mesh keeps it unsharded too: the probe runs as one
        plain dispatch on position 0, only the folds ride the exchange."""
        return None

    def _devprobe_dispatch(self, step, keys: np.ndarray, panes: np.ndarray,
                           values, B: int, label: str) -> np.ndarray:
        """Upload a block of rows (the int64 keys as they are, their pane
        slots, the values) and run the probed ``step`` on it, one guarded
        dispatch under ``label`` (``device_probe``, or ``fused_scan`` for a
        super-batch); count hits and misses.  The card hashes the keys, so
        the host does no per-record hash or split.  Returns the miss rows'
        indices on the host; raises :class:`DeviceQuarantinedError` for the
        caller to degrade."""
        leaves = [np.asarray(a) for a in tree_leaves(values)]
        geom = (label, self._dki.capacity, self._K, self._P,
                _next_pow2(B, 64),
                tuple((a.dtype.str, a.shape[1:]) for a in leaves))
        mb = (12 * B + sum(a.nbytes for a in leaves)) / 1e6
        miss_idx = self._guarded(
            label, geom, mb,
            lambda: step(self._dki.buckets,
                         self._ids_to_device(np.ascontiguousarray(keys,
                                                                  np.int64)),
                         self._ids_to_device((panes % self._P).astype(
                             np.int32)),
                         self._to_device(values)))
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
        try:
            with self._phase("device_probe"):
                mi = self._devprobe_dispatch(step, keys, panes, values, B,
                                             "device_probe")
        except DeviceQuarantinedError as err:
            self._devprobe_degrade(err, keys, panes, values)
            return
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
        the plain (guarded) update step.  Callers reach here only after
        every record is accounted for in the mirror (warm rows in the delta,
        miss rows folded), so a quarantine degrades without refolding."""
        flat = mslots.astype(np.int64) * self._P + (mpanes % self._P)
        leaves = [np.asarray(a) for a in tree_leaves(mvalues)]
        try:
            with self._phase("device_dispatch"):
                self._guarded_update(
                    lambda: self._update_step(self._ids_to_device(flat),
                                              self._to_device(mvalues)),
                    int(flat.size), leaves,
                    (flat.nbytes + sum(a.nbytes for a in leaves)) / 1e6)
        except DeviceQuarantinedError as err:
            self._devprobe_degrade(err)

    # ------------------------------------------------------------ fused lane
    def _fused_depth(self, sync: str) -> int:
        """The super-batch staging depth for a batch under the resolved
        ``sync`` (1 = off), resolved once per operator: forced by
        ``superbatch > 1``, measured by :func:`calibrated_superbatch` under
        0 on the host tier (JAX stages only there; here a forced depth
        stages the device tier too), 1 under paging, count triggers and
        aggregates with no scatter kinds.  Batches stay unfused
        while the sync cadence calibrates (it times per-batch steps)."""
        if sync not in ("scatter", "deferred"):
            return 1
        if self._fused_resolved is None:
            # count triggers read the counts after every batch (JAX stages
            # neither them nor the device tier); a generic fold over a
            # concatenated super-batch would group its combines otherwise
            if (self._pager is not None or self.superbatch == 1
                    or self.trigger.fires_on_count or self.kinds is None):
                self._fused_resolved = 1
            elif self.superbatch > 1:
                self._fused_resolved = self.superbatch
            elif self.emit_tier != "host":
                self._fused_resolved = 1
            else:
                self._fused_resolved = calibrated_superbatch()
        return self._fused_resolved

    def _fused_super_shards(self):
        """(shards, shard_div, shard_ns) of the C pass over a concatenated
        super-batch: with ``native_shards=0``, the larger of the per-batch
        count and the one measured at super-batch size
        (:func:`calibrated_super_shards`); the mesh keeps its block-aligned
        ranges."""
        shards, shard_div, shard_ns = self._probe_shards()
        if shard_div == 0 and self.native_shards == 0:
            if not self._fused_shards:
                self._fused_shards = calibrated_super_shards()
            shards = max(shards, self._fused_shards)
        return shards, shard_div, shard_ns

    def fused_stats(self) -> Dict[str, int]:
        """Fused-lane counters, under JAX's names: batches staged, flushes,
        one-step passes over a super-batch with the probe on
        (``scan_dispatches``) and the batches they covered
        (``scan_steps``), concatenated passes with the probe off
        (``host_super_passes``), the batches parked now, and the guarded
        hot-path dispatches (``hot_dispatches``: dispatches per batch).  No
        pipeline barrier (monitoring-grade)."""
        s = dict(self._fused_counters)
        s["enabled"] = int((self._fused_resolved or 1) > 1)
        s["depth"] = self._fused_resolved or (
            self.superbatch if self.superbatch > 1 else 0)
        s["staged_pending"] = len(self._fused_stage)
        s["hot_dispatches"] = self._hot_dispatches
        return s

    # ------------------------------------------------------------- pipeline
    def _pipe_pending(self) -> bool:
        return self._pipe is not None and self._pipe.pending()

    def flush_pipeline(self) -> List[StreamElement]:
        """Barrier before any state read: complete every in-flight hot stage
        (a parked stage error re-raises here), then advance every staged
        batch.  The operator calls it before fires, expiry, snapshots,
        restore, verification, refresh and late re-fires; a task loop may
        call it at idle points.  A no-op when nothing is in flight or
        staged."""
        if self._pipe is not None:
            self._pipe.flush()
        self._fused_flush()
        return []

    def _staging_acquire(self, rows: int, flat_dtype, leaves) -> _Staging:
        """A free upload set for ``rows`` (a power of two), reused once its
        token is ready; at most 4 sets are kept per key (past that the
        device is the backlog, and a fresh set is not pooled)."""
        key = (rows, np.dtype(flat_dtype).str,
               tuple((a.dtype.str, a.shape[1:]) for a in leaves))
        pool = self._staging_pool.setdefault(key, [])
        for st in pool:
            if st.ready():
                st.token = None
                return st
        st = _Staging(rows, flat_dtype, leaves, self.device.type == "cuda")
        if len(pool) < 4:
            pool.append(st)
        return st

    def _resolve_device_sync(self) -> str:
        """The sync cadence for this batch: "scatter", "deferred", or
        "calibrating" (scatter, and the batch's step is timed).  Off the
        host tier, or with a device-sourced snapshot, the replica is the
        authority and always scatters.  Under "auto" the first batches
        feed :mod:`~flink_tpu_torch.utils.transport` until it has a verdict
        (process-wide); after 8 batches too small to give a sample the
        lane settles on scatter."""
        if self.device_sync_mode is not None:
            return self.device_sync_mode
        if (self.device_sync == "scatter" or self.emit_tier != "host"
                or self.snapshot_source != "mirror"):
            self.device_sync_mode = "scatter"
        elif self.device_sync == "deferred":
            self.device_sync_mode = "deferred"
        else:
            taxed = transport.dispatch_taxed()
            if taxed is None:
                if self._calib_batches < 8:
                    self._calib_batches += 1
                    return "calibrating"
                self.device_sync_mode = "scatter"
            else:
                self.device_sync_mode = "deferred" if taxed else "scatter"
        return self.device_sync_mode

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
        # a degraded host tier folds the mirror only (deferred semantics)
        sync = "deferred" if self._degraded else self.device_sync_mode
        if self._FUSED_SCAN and len(st) > 1 and self._devprobe_active(sync):
            self._fused_flush_scan(st)
            return
        if len(st) == 1:
            keys, panes, values, B = st[0]
        else:
            self._fused_counters["host_super_passes"] += 1
            with self._phase("fused_scan"):
                keys, panes, values, B = concat_staged(st)
        self._advance_batch(keys, panes, values, B, sync,
                            super_pass=len(st) > 1)

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
            try:
                mi = self._devprobe_dispatch(step, keys, panes, values, R,
                                             "fused_scan")
            except DeviceQuarantinedError as err:
                # whatever this pass wrote is dropped (the delta ring) or
                # rebuilt at re-promotion (the replica), and a pass stopped
                # mid-write refuses the delta salvage: salvage the prior
                # delta, degrade, and refold EVERY staged batch through the
                # host pass (JAX's _fused_scan_degrade)
                self._devprobe_degrade(err, keys, panes, values)
                return
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
                       B: int, sync: str, super_pass: bool = False) -> None:
        """The probe lane or the plain fold lane for one block of rows
        (``super_pass``: a concatenated super-batch)."""
        if self._devprobe_active(sync):
            self._hot_stage_devprobe(keys, panes, values, B)
        else:
            self._hot_stage_fold(keys, panes, values, sync, super_pass)

    # -------------------------------------------------- deferred sync point
    def device_refresh(self) -> None:
        """Rebuild the device replica from the authoritative host mirror:
        deferred sync's sync point (verification, or a caller's explicit
        hand-off).  Set semantics over the whole ring: slots without a live
        pane reset to identity, which also applies the expirations skipped
        while deferred.  The upload covers live panes x live key rows.  A
        no-op when the replica is current, and while degraded (re-promotion
        rebuilds it)."""
        self.flush_pipeline()
        if self._degraded or not self._device_stale:
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
        for _, lb, cb in self._row_blocks(self._leaves, self._counts):
            for l, init in zip(lb, self.spec.leaf_inits):
                l.fill_(np.asarray(init).item())
            cb.zero_()
        if not live:
            return
        self._set_columns(self._leaves, self._counts,
                          np.asarray(live, np.int64) % self._P, counts_cols,
                          leaf_cols)

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
        """Exact ascending key-slot ids (ring rows, when paged) that hold
        data in any of ``panes``."""
        if self._pager is not None:
            # paged: live rows are bounded by the assigned-row high-water
            # mark, not by the key count
            n = self._pager.row_high_water
        else:
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
        """[counts, *leaves] arrays of a pane, allocated/grown to K rows — or
        past K while degraded: a degraded paged operator holds every key in
        the mirror, not just the ring's."""
        need = self._K
        if self._degraded and self.key_index is not None:
            need = max(need, _next_pow2(max(self.key_index.num_keys, 1)))
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
        round trip (ring mapping, dtype casts, skipped expirations).  True
        while degraded: the replica is stale or gone on purpose."""
        self.flush_pipeline()
        if self._degraded:
            return True
        if self.device_sync_mode == "deferred":
            self.device_refresh()
        self._devprobe_sync_mirror(None)
        if self.emit_tier != "host" or self._leaves is None \
                or self.pane_base is None:
            return True     # the device tier has no value mirror
        n = self.key_index.num_keys if self.key_index else 0
        for p in range(self.pane_base, (self.max_pane or 0) + 1):
            slot = int(p) % self._P
            dev_counts, dev_leaves = self._ring_columns(
                self._leaves, self._counts, np.asarray([slot]), n)
            if self._nm is not None:
                _ex, cnts, lvs = self._nm.export_pane(p, n)
                host = [cnts] + lvs
            else:
                host = self._vmirror.get(p)
            host_counts = (host[0][:n] if host is not None
                           else np.zeros(n, np.int64))
            if not np.array_equal(dev_counts[:, 0], host_counts):
                return False
            for j in range(self.spec.num_leaves):
                dev = dev_leaves[j][:, 0].astype(np.float64)
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
    def _round_key_capacity(self, needed: int) -> int:
        """The key capacity for ``needed`` keys: powers of two from the
        current one; the mesh strengthens it (a multiple of D).  Paged
        state never grows: overflow pages out."""
        if self._pager is not None:
            return self._K
        return _next_pow2(needed, self._K)

    def _grow_keys(self, needed: int):
        newK = self._round_key_capacity(needed)
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
            self._copy_rows(old_leaves, old_counts, fresh, fresh_counts)
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
            src = torch.from_numpy(panes % oldP)
            dst = torch.from_numpy(panes % newP)
            for (_, fl, fc), (_, ol, oc) in zip(
                    self._row_blocks(fresh, fresh_counts),
                    self._row_blocks(old_leaves, old_counts)):
                s, t = src.to(fc.device), dst.to(fc.device)
                for f, o in zip(fl, ol):
                    f[:, t] = o[:, s]
                fc[:, t] = oc[:, s]
        self._leaves, self._counts = fresh, fresh_counts

    def _grow_panes_guarded(self, span: int) -> None:
        """Ring growth.  A degraded device tier has no device ring (its
        state lives in the host value mirror, keyed by pane id): only ``P``
        advances, and re-promotion allocates at the final geometry."""
        if self._degraded and self.emit_tier != "host":
            while self._P < span:
                self._P <<= 1
            return
        if self._delta_counts is not None and span > self._P:
            # the delta ring reallocates with P: drain it into the mirror
            # first, rebuild at the new P on the next probe step
            self._devprobe_sync_mirror(None)
            self._drop_delta()
        self._ensure_alloc()
        self._grow_panes(span)

    def _staged_update(self, staging: _Staging, flat: Optional[np.ndarray],
                       values, leaves, B: int, calibrating: bool) -> None:
        """Upload one batch through its upload set and fold it into the
        replica, one guarded dispatch; on the card the copies are
        ``non_blocking`` from pinned buffers, and the dispatch's fence event
        frees the set.  While the sync cadence calibrates, the upload, the
        launches and the wait for the card are timed into
        :mod:`~flink_tpu_torch.utils.transport`.  Raises
        :class:`DeviceQuarantinedError` for the caller to degrade."""
        t0 = time.perf_counter()
        with self._phase("device_dispatch"):
            host_flat, host_leaves = staging.fill(flat, leaves, B)
            nbytes = host_flat.nbytes + sum(a.nbytes for a in host_leaves)

            def prepare():
                flat_t = host_flat.to(self.device, non_blocking=True)
                dev = [a.to(self.device, non_blocking=True)
                       for a in host_leaves]
                return self._update_step(
                    flat_t, tree_unflatten(tree_structure(values), dev))
            self._guarded_update(prepare, B, leaves, nbytes / 1e6)
            self.phase_bytes["h2d"] = self.phase_bytes.get("h2d", 0) + nbytes
            staging.token = self._fence
        if calibrating:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            transport.record_dispatch_cost(nbytes / 1e6,
                                           time.perf_counter() - t0)

    # ------------------------------------------------------------- device ops
    def _update_step(self, flat_ids: torch.Tensor, values):
        """One micro-batch fold into the device replica: lifts now and
        returns the write, the ordered fold in place (on the card
        ``csrc/scatter_fold.cu``, which adds each cell's rows in row order).
        flat_ids in [0, K*P]; K*P is a dropped row.  With sharded state
        (placement, no exchange) every block folds the rows of its range,
        in row order, each on its own device.  An aggregate with no scatter
        kinds takes the generic fold (:meth:`_generic_fold`)."""
        if self.kinds is None:
            return self._generic_update(flat_ids, values)
        lifted = tuple(tree_leaves(self.agg.lift(values)))
        if self.sharding is None:
            return lambda: ordered_fold_counts(
                *self._flat_state(self._leaves, self._counts), flat_ids,
                lifted, self.kinds)

        def write():
            P = self._P
            for lo, lb, cb in self._row_blocks(self._leaves, self._counts):
                cells = cb.shape[0] * P
                with self._on_device(cb.device):
                    ids = flat_ids.to(cb.device, torch.int64) - lo * P
                    ids = torch.where((ids >= 0) & (ids < cells), ids, cells)
                    ordered_fold_counts(*self._flat_state(lb, cb), ids,
                                        tuple(l.to(cb.device)
                                              for l in lifted), self.kinds)
        return write

    def _generic_values(self, values, rows: int):
        """A batch's value tree for the generic fold, as JAX's step sees
        it: 64-bit leaves narrowed to 32 bits (x64 off), and padded with
        zero rows to ``rows``."""
        def leaf(a):
            a = canonical_tensor(a)
            if a.shape[0] == rows:
                return a
            pad = torch.zeros((rows - a.shape[0],) + tuple(a.shape[1:]),
                              dtype=a.dtype, device=a.device)
            return torch.cat([a, pad])
        return tree_unflatten(tree_structure(values),
                              [leaf(a) for a in tree_leaves(values)])

    def _generic_update(self, flat_ids: torch.Tensor, values):
        """:meth:`_update_step` for an aggregate with no scatter kinds: the
        batch padded to JAX's staged length (``next_pow2(B, 64)`` rows, the
        pad rows dropped), lifted now; the write is the generic fold."""
        B = flat_ids.shape[0]
        Bp = _next_pow2(B, 64)
        cells = self._K * self._P
        ids = torch.cat([flat_ids, torch.full((Bp - B,), cells,
                                              dtype=flat_ids.dtype,
                                              device=flat_ids.device)])
        lifted = tuple(tree_leaves(self.agg.lift(
            self._generic_values(values, Bp))))
        return lambda: self._generic_fold(self._leaves, self._counts, ids,
                                          lifted)

    def _generic_fold(self, leaves, counts, flat_ids: torch.Tensor,
                      lifted) -> None:
        """The generic fold of a batch into ``[K, P]`` state, in place:
        ``scatter_generic`` over the flat cells (a stable sort, JAX's
        segmented scan, one write per segment end) and the counts added
        with ``index_add_`` (integers: the order does not matter).  With
        row blocks the scan runs once over the global ids, as JAX's single
        partitioned step does, and each block combines and writes its own
        segment ends on its device."""
        combine = self.agg.combine_leaves
        P = self._P
        blocks = self._row_blocks(leaves, counts)
        if len(blocks) == 1:
            flat_leaves, flat_counts = self._flat_state(*blocks[0][1:])
            cells = flat_counts.shape[0]
            scatter_generic(flat_leaves, flat_ids, lifted, combine, cells)
            _add_counts(flat_counts, flat_ids, cells)
            return
        sids, is_end, folded = segment_fold(flat_ids, lifted, combine)
        for lo, lb, cb in blocks:
            cells = cb.shape[0] * P
            with self._on_device(cb.device):
                flat_leaves, flat_counts = self._flat_state(lb, cb)
                local = sids.to(cb.device, torch.int64) - lo * P
                keep = is_end.to(cb.device) & (local >= 0) & (local < cells)
                idx = local[keep]
                cur = tuple(l[idx] for l in flat_leaves)
                merged = combine(cur, tuple(f.to(cb.device)[keep]
                                            for f in folded))
                for l, m in zip(flat_leaves, merged):
                    l[idx] = m.to(l.dtype)
                ids = flat_ids.to(cb.device, torch.int64) - lo * P
                _add_counts(flat_counts, ids, cells)

    # ------------------------------------------ device-lane health (guard)
    def _on_card(self):
        """The operator's card as the calling thread's current CUDA device
        (the current device is per host thread; a lane thread starts on
        device 0); a no-op on the CPU."""
        return self._on_device(self.device)

    def _record_fence(self):
        """A CUDA event recorded after the launches on every device that
        holds state (one event, or an :class:`_EventSet` over several
        cards); None on the CPU."""
        events = []
        for dev in self._state_devices():
            if dev.type != "cuda":
                continue
            with self._on_device(dev):
                ev = torch.cuda.Event()
                ev.record()
            events.append(ev)
        if not events:
            return None
        return events[0] if len(events) == 1 else _EventSet(events)

    def _guarded(self, label: str, geom: tuple, mb: float,
                 prepare: Callable[[], Callable[[], Any]],
                 on_oom: Optional[Callable[[], None]] = None):
        """One hot-path dispatch under the process-wide watchdog
        (``runtime/device_health.py``): bounded deadline, transient retry
        with backoff, ``on_oom`` then one retry, wedge -> quarantine (raised
        as :class:`DeviceQuarantinedError` for the caller to degrade).

        ``prepare`` does every allocation and upload and returns the write,
        which does the in-place writes and returns the dispatch's result.
        The thunk, on the caller's lane thread under :meth:`_on_card`:

        1. refuses (FATAL, the restart path) if an earlier attempt stopped
           after its first in-place write: in-place state has no donated
           buffers, so a retry of such an attempt would fold rows twice;
        2. waits on the previous guarded dispatch's CUDA event (the fence:
           a CUDA launch returns before the card runs it, so a kernel that
           never ends trips THIS dispatch's deadline);
        3. prepares, then, under ``_tier_lock``, refuses if a tier
           migration began since the dispatch did (an attempt abandoned in
           its fence wait or its prepare wakes when the card comes back,
           as the migration's own download does, and must not write into
           the state that download reads) and sets ``_writing``;
        4. writes, records the new fence event (one on each card that holds
           state, :meth:`_record_fence`), clears ``_writing``.

        ``geom``: the first dispatch of a site (``label``) after a change of
        K, P, batch rows (pow2) or leaf dtypes gets the compile grace — an
        nvcc build or a first allocation after growth.  JAX's rule, kept
        per site: JAX keeps one geometry for all sites, so where two sites
        alternate (the probe step and its miss catch-up) every dispatch
        reads as new and gets the grace."""
        fresh = self._dispatch_geoms.get(label) != geom
        self._dispatch_geoms[label] = geom
        self._hot_dispatches += 1
        with self._tier_lock:
            epoch = self._tier_epoch

        def thunk():
            with self._on_card():
                if self._writing:
                    raise RuntimeError(
                        f"{self.name}.{label}: an earlier attempt stopped "
                        f"after its first in-place write; the state cannot "
                        f"be trusted in process")
                if self._fence is not None:
                    self._fence.synchronize()
                write = prepare()
                with self._tier_lock:
                    if epoch != self._tier_epoch:
                        raise DeviceQuarantinedError(
                            f"{self.name}.{label}: superseded by a tier "
                            f"migration")
                    self._writing = True
                out = write()
                if self.device.type == "cuda":
                    self._fence = self._record_fence()
                self._writing = False
                return out

        return device_health.guarded_dispatch(
            thunk, mb=mb, on_oom=on_oom, label=f"{self.name}.{label}",
            compile_grace=fresh)

    def _guarded_update(self, prepare, rows: int, leaves, mb: float) -> None:
        """The replica fold (:meth:`_update_step`) under the watchdog, label
        ``update_step``; on a paged operator an OOM forces a page-out
        (:meth:`_forced_page_out`) and retries once."""
        geom = (self._K, self._P, _next_pow2(rows, 64),
                tuple((a.dtype.str, a.shape[1:]) for a in leaves))
        self._guarded("update_step", geom, mb, prepare,
                      on_oom=(self._forced_page_out
                              if self._pager is not None else None))

    # ------------------------------------------ device-lane health (tiers)
    def _salvage(self, err: BaseException, read: Callable[[], Any],
                 label: str):
        """A migration's state download, run under the monitor's bounded
        salvage deadline on the caller's lane (under :meth:`_on_card`).
        Where the state cannot be read back in process — an attempt stopped
        after its first in-place write (the port's counterpart of JAX's
        donated-and-deleted buffers), the card misses the deadline, or the
        read fails — ``err`` re-raises from that cause: the task takes the
        restart path and recovers from its last checkpoint.  The tier epoch
        moves first, with the flag read under the same lock: from here on
        no abandoned dispatch starts a write."""
        def on_card():
            with self._on_card():
                return read()
        with self._tier_lock:
            self._tier_epoch += 1
            writing = self._writing
        try:
            if writing:
                raise RuntimeError(
                    f"{self.name}: a dispatch stopped after its first "
                    f"in-place write; in-process salvage is impossible")
            mon = device_health.get_monitor(create=False)
            return (mon.run_salvage(on_card, label=label) if mon is not None
                    else on_card())
        except Exception as cause:  # noqa: BLE001 — state unrecoverable
            raise err from cause

    def _devprobe_degrade(self, err: BaseException, keys=None, panes=None,
                          values=None) -> None:
        """Quarantine with the device probe active: salvage the unsynced
        delta ring into the mirror (:meth:`_salvage`), drop the delta ring
        and the device table, degrade the tier, and — when ``keys`` is
        given — fold those rows, not yet accounted for, through the host
        pass so no record is lost.  Call sites that fail after every record
        reached the mirror (warm rows in the delta, misses folded) pass no
        rows."""
        if self._delta_counts is not None and self._delta_panes:
            self._salvage(err, lambda: self._devprobe_sync_mirror(None),
                          f"{self.name} delta salvage")
        self._drop_delta()
        self._dki = None
        self._devprobe_resolved = None   # re-resolved after a heal
        self._enter_degraded(err)        # host tier: flags only
        if keys is None or len(keys) == 0:
            return
        with self._phase("probe_mirror"):
            if self._nm is not None:
                self._native_probe_update(keys, panes, values)
            else:
                slots = self.key_index.lookup_or_insert(keys)
                self._vmirror_update(slots, panes, values)

    def _enter_degraded(self, err: BaseException) -> None:
        """Quarantine migration: leave the device tier MID-JOB.  The host
        tier just stops dispatching (its mirror is the authority); the
        device tier downloads its live pane ring through the dense
        gid-indexed snapshot path (both pager tiers merged) into the host
        value mirror, then drops its device state.  An aggregate with no
        host twin re-raises, and so does sharded state without the mesh's
        whole-mesh degrade (``_SHARDED_DEGRADE``): the task fails and the
        restart path recovers it; so do count triggers and GlobalWindows,
        whose per-key fire registers have no host tier."""
        if (not self.agg.supports_host_emit()
                or (self.sharding is not None and not self._SHARDED_DEGRADE)
                or self.trigger.fires_on_count
                or isinstance(self.assigner, GlobalWindows)):
            raise err
        self._quarantine_migrations += 1
        if self.emit_tier == "host":
            self._degraded = True
            self._device_stale = True
            self._cut_dispatches()
            return
        n = self.key_index.num_keys if self.key_index is not None else 0
        if self._leaves is not None and self.pane_base is not None and n:
            panes = self._live_panes()

            def gather():
                if self._pager is not None:
                    return self._paged_snapshot_rows(n, panes)
                return self._device_columns(panes, n)
            counts, leaves = self._salvage(err, gather,
                                           f"{self.name} migration")
            self._degraded = True   # _vmirror_pane sizes past K now
            self._vmirror = {}
            for j, p in enumerate(panes.tolist()):
                if not counts[:, j].any():
                    continue
                entry = self._vmirror_pane(int(p))
                entry[0][:n] = counts[:, j]
                for k, src in enumerate(leaves):
                    entry[k + 1][:n] = src[:, j].astype(
                        self._mirror_dtypes[k])
        self._degraded = True
        self._drop_device_arrays()

    def _cut_dispatches(self) -> None:
        """Bump the tier epoch, so an in-flight promotion or an abandoned
        dispatch can no longer commit or write, and drop the fence and the
        upload sets of the old tier."""
        with self._tier_lock:
            self._tier_epoch += 1
        self._fence = None
        self._staging_pool = {}

    def _drop_device_arrays(self) -> None:
        """Tear down the device tier's in-process state (the mirror stays
        authoritative): the migration's and the false heal's one copy."""
        self._cut_dispatches()
        self._leaves = None
        self._counts = None
        self._mirror = {}
        self._active_rows = None
        if self._pager is not None:
            self._pager.reset()

    def _forced_page_out(self) -> None:
        """Device-OOM pressure valve (the monitor's ``on_oom``): spill the
        cold half of the resident rows so the retried dispatch has memory.
        The batch's own rows stay protected — its flat ids reference
        them."""
        pager = self._pager
        if pager is None or self.pane_base is None:
            return
        rows, _gids = pager.resident_pairs()
        protected = (self._active_rows if self._active_rows is not None
                     else np.empty(0, np.int64))
        evictable = int(rows.size) - int(protected.size)
        k = max(1, evictable // 2) if evictable > 0 else 0
        if k <= 0:
            return
        live = self._live_panes()
        victims = pager.pick_victims(k, protected)
        if victims.size == 0:
            return
        counts, leaves = self._gather_rows(victims, live)
        bits = self._mirror_bits_rows(victims, live)
        pager.spill_rows(victims, live, counts, leaves, bits)
        self._clear_mirror_rows(victims)

    def _maybe_repromote(self) -> bool:
        """Checkpoint-aligned safe point: if the process-wide monitor healed
        the card, re-promote this operator's state and leave degraded mode.
        The upload runs guarded (a subprocess probe can read healthy while
        this process's card still hangs: a false heal must not hang the task
        thread) and ends with a synchronize, so a card that still hangs
        trips its deadline.  The commit happens here, on the task thread,
        after the guarded upload returned; a false heal rolls back and bumps
        the epoch.  Returns True when a re-promotion happened."""
        if not self._degraded:
            return False
        mon = device_health.get_monitor(create=False)
        if mon is None or not mon.healthy:
            return False
        self.flush_pipeline()

        def promote():
            with self._on_card():
                if self.emit_tier == "host":
                    self._degraded = False   # device_refresh no-ops otherwise
                    try:
                        self.device_refresh()  # the stale replica, rebuilt
                    except BaseException:
                        self._degraded = True
                        raise
                else:
                    self._repromote_device()   # uploads only, no commit
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)

        try:
            mon.run_guarded(promote, label=f"{self.name} re-promotion",
                            compile_grace=True)
        except DeviceQuarantinedError:
            # false heal: stay on the host tier (the mirror, dropped only
            # after a committed promotion, is still the authority); the
            # epoch bump fences the abandoned attempt out of committing
            self._degraded = True
            self._device_stale = True
            if self.emit_tier != "host":
                self._drop_device_arrays()
            else:
                self._cut_dispatches()
            return False
        if self.emit_tier != "host":
            self._degraded = False
            self._vmirror = {}
            self._device_stale = False
        self._repromotions += 1
        return True

    def _repromote_device(self) -> None:
        """The device tier's quarantine exit, UPLOAD HALF: rebuild the pane
        ring (and the pager's residency) from the host value mirror through
        the restore path.  Commits no tier flag and keeps ``_vmirror``;
        the writes are fenced on the tier epoch taken at entry, so an
        abandoned attempt that limps on later aborts instead of landing
        stale state."""
        n = self.key_index.num_keys if self.key_index is not None else 0
        if n == 0 or self.pane_base is None:
            return
        with self._tier_lock:
            epoch = self._tier_epoch
        panes = self._live_panes()
        counts, leaves = self._mirror_columns(panes.tolist(), n)
        with self._tier_lock:
            if epoch != self._tier_epoch:
                raise DeviceQuarantinedError("re-promotion superseded")
            self._K = self._round_key_capacity(max(n, 1))
            self._ensure_alloc()
            self._mirror = {}
            if self._pager is not None:
                self._paged_restore_rows(n, panes, counts, leaves)
            else:
                self._upload_columns(panes, counts, leaves)

    def device_health_stats(self) -> Dict[str, int]:
        """Tier-degradation counters (no pipeline barrier, as
        ``paging_stats``): degraded now, migrations, re-promotions."""
        return {"degraded": int(self._degraded),
                "quarantine_migrations": self._quarantine_migrations,
                "repromotions": self._repromotions}

    def _clear_panes_step(self, pane_slots: torch.Tensor) -> None:
        """Reset ring columns of expired panes to identity, in place."""
        self._clear_columns(self._leaves, self._counts, pane_slots,
                            [np.asarray(i).item()
                             for i in self.spec.leaf_inits])

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
        if self._qview is not None:
            # every fire path (host mirror, device gather, async fire, paged
            # chunks, degraded tier, mesh) comes through here, so a live read
            # is the fire's own values
            self._qview.publish(
                keys, {c: v for c, v in cols.items()
                       if c != self.key_column},
                window, self.watermark, self._last_completed_checkpoint)
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
        step = max(self._K // 2, 1) if self._pager is not None else 0
        if step and len(batch) > step:
            # a batch's distinct keys (plus their eviction protections) must
            # fit the resident capacity: split oversized batches (comparing
            # against the clamped step keeps K_cap=1 from recursing forever)
            out = list(pending)
            for lo in range(0, len(batch), step):
                out.extend(self.process_batch(
                    batch.take(np.arange(lo, min(lo + step, len(batch))))))
            return out
        cols = batch.columns
        keys = np.asarray(cols[self.key_column])
        if self.key_index is None:
            sample = np.asarray(keys[0] if keys.ndim else keys)
            self._bind_key_index(object_keys=not (
                sample.ndim == 0 and sample.dtype.kind in "iu"))
        if self.assigner.is_event_time:
            if batch.timestamps is None:
                raise ValueError(
                    "event-time window requires timestamps "
                    "(assign_timestamps_and_watermarks upstream)")
            ts = np.asarray(batch.timestamps, np.int64)
        else:
            ts = np.full(len(batch), self._now_ms(), np.int64)
        global_windows = isinstance(self.assigner, GlobalWindows)
        panes = self.assigner.pane_of(ts)

        # ---- late-beyond-lateness drop, judged like the reference's
        # WindowOperator.isElementLate: a record is late iff its pane's last
        # covering window's cleanup time (end - 1 + lateness) was passed.
        # The gate's clock is the assigner's time domain: processing time
        # ticks on event-time operators too and is never compared with
        # event-time panes
        gate_now = (self.watermark if self.assigner.is_event_time
                    else self._proc_time)
        if gate_now != LONG_MIN and not global_windows:
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
                if self.late_output_tag is not None:
                    # sideOutputLateData: the rows ship, they are not
                    # dropped, so the drop counter stays as the reference's
                    # (WindowOperator.java:437 counts only what no side
                    # output takes)
                    pending = list(pending) + [TaggedBatch(
                        self.late_output_tag, batch.select(~live))]
                else:
                    self.late_dropped += int(np.count_nonzero(~live))
                batch = batch.select(live)
                if len(batch) == 0:
                    return pending
                cols = batch.columns
                keys = np.asarray(cols[self.key_column])
                panes = panes[live]

        pmin, pmax = int(panes.min()), int(panes.max())
        values = self._select(cols)
        if self.incremental_state:
            # every (key, pane) the batch touches stays dirty until a cut
            # holding it is confirmed; raw keys resolve to key ids at the
            # cut (the index is append-only)
            self._incr_mark_batch(keys, panes)
        if self.pipeline_depth > 0 and not self.trigger.fires_on_count:
            # the two-stage pipeline: the hot stage runs on the worker while
            # this thread returns to its loop; every state read below and
            # elsewhere waits for it (flush_pipeline).  Count triggers read
            # the counts after every batch, so they stay serial (JAX's)
            if self._pipe is None:
                self._pipe = _HotPipeline(self.pipeline_depth, self.device)
            B = len(batch)
            self._pipe.submit(lambda: self._hot_stage(keys, panes, values,
                                                      B, pmin, pmax))
        else:
            self._hot_stage(keys, panes, values, len(batch), pmin, pmax)

        out: List[StreamElement] = list(pending)
        if self.trigger.fires_on_count:
            with self._phase("fire"):
                if global_windows:
                    out.extend(self._fire_by_count())
                else:
                    # over time windows: the (key, window) cells whose
                    # count crossed the threshold
                    out.extend(self._fire_count_in_panes(np.unique(panes)))
        # ---- late re-fire: windows already passed by the watermark that
        # this batch updated fire again (EventTimeTrigger.onElement FIRE)
        if (self.trigger.fires_on_time and self.assigner.is_event_time
                and self.last_fired_window is not None
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
        """The hot stage of one micro-batch: pane-ring bookkeeping/growth,
        then the fused lane's stage (depth > 1), or the probe lane or the
        plain fold lane.  Inline when the pipeline is off, on its worker
        when on: the same code in the same order either way."""
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
        if self._degraded and self.emit_tier != "host":
            # quarantined device tier: the host value mirror is the
            # authority — key lookup + numpy fold only (no paging, no
            # device dispatch) until re-promotion
            with self._phase("probe"):
                slots = self.key_index.lookup_or_insert(keys)
            with self._phase("mirror"):
                # grow EVERY live pane with the key count: an untouched
                # pane must still serve fires, snapshots and re-promotion
                for p in list(self._vmirror):
                    self._vmirror_pane(p)
                self._vmirror_update(slots, panes, values)
            return
        sync = self._resolve_device_sync()
        if self._degraded:
            # quarantined host tier: the mirror is the authority anyway —
            # skip the replica dispatch (deferred semantics)
            sync = "deferred"
        if self._fused_depth(sync) > 1:
            # fused lane: park the batch; the whole super-batch advances in
            # one pass at the flush boundary (depth or row bound here, a
            # fire boundary or any state read through flush_pipeline)
            self._fused_stage.push(keys, panes, values, B)
            self._fused_counters["staged_batches"] += 1
            if (len(self._fused_stage) >= self._fused_resolved
                    or self._fused_stage.rows >= MAX_STAGED_ROWS):
                self._fused_flush()
            return
        self._advance_batch(keys, panes, values, B, sync)

    def _hot_stage_fold(self, keys: np.ndarray, panes: np.ndarray, values,
                        sync: str, super_pass: bool = False) -> None:
        """Plain lane: host key lookup and mirror fold, the device fold
        (scatter sync only; "calibrating" folds as scatter and times the
        step).  With the native mirror, one C pass does the lookup and the
        fold and, under scatter sync, writes the int32 scatter ids the
        device fold takes into the upload set.  On the device tier the key
        index resolves the rows, the replica takes the fold, and the emit
        mirror marks the cells."""
        B = len(keys)
        leaves = [np.asarray(a) for a in tree_leaves(values)]
        staging = None
        if self._nm is not None:
            with self._phase("probe_mirror"):
                flat_out = None
                if sync != "deferred":
                    staging = self._staging_acquire(_next_pow2(B, 64),
                                                    np.int32, leaves)
                    flat_out = staging.flat_out(B)
                self._native_probe_update(keys, panes, values, flat_out,
                                          super_pass=super_pass)
        else:
            with self._phase("probe"):
                slots = self.key_index.lookup_or_insert(keys)
        if self._pager is None and self.key_index.num_keys > self._K:
            self._ensure_alloc()
            self._grow_keys(self.key_index.num_keys)
        self._ensure_alloc()
        # key ids before paging: a quarantine migration folds by global id
        gids = slots if self._nm is None else None
        if self._pager is not None:
            # key ids -> resident ring rows, paging cold keys out and
            # promoted keys in; the flat ids and the emit marks use rows
            with self._phase("paging"):
                slots = self._page_slots(slots)
        if sync == "deferred":
            # the mirror is the authority; the replica catches up at the
            # next device_refresh
            self._device_stale = True
        else:
            flat = None
            if staging is None:
                # int32 ids where the cells fit: half the upload
                idt = np.int32 if self._K * self._P < 2 ** 31 else np.int64
                flat = (slots.astype(idt) * idt(self._P)
                        + (panes % self._P).astype(idt))
                staging = self._staging_acquire(_next_pow2(B, 64), idt,
                                                leaves)
            try:
                self._staged_update(staging, flat, values, leaves, B,
                                    calibrating=sync == "calibrating")
            except DeviceQuarantinedError as err:
                # the card wedged mid-batch: migrate to the host tier and
                # fold THIS batch there — no record is dropped
                self._enter_degraded(err)
                with self._phase("mirror"):
                    if self.emit_tier == "device":
                        self._vmirror_update(gids, panes, values)
                    elif self._nm is None:   # the C pass already folded
                        self._vmirror_update(slots, panes, values)
                return
        if self.emit_tier == "device":
            # sharded unpaged state fires at full capacity and keeps no
            # emit mirror (JAX's); the paged mesh keeps it for its fires
            if self.sharding is None or self._pager is not None:
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
        if ((self._pipe_pending() or self._fused_stage)
                and not self.async_fire and self.lateness == 0
                and self.trigger.fires_on_time and self.assigner.is_event_time
                and not isinstance(self.assigner, GlobalWindows)
                and self.last_fired_window is not None
                and self._fired_horizon(self.watermark)
                <= self.last_fired_window):
            # the watermark passed no new window end, and with lateness 0
            # pane expiry coincides with fires: nothing fires or expires, no
            # state is read, and the in-flight stages stay in flight and
            # the staged batches parked (the pipeline's overlap comes from
            # here on task loops that send a watermark after every batch)
            return []
        if not (self.trigger.fires_on_time and self.assigner.is_event_time):
            # count triggers do not FIRE on time, but window state still
            # retires at window end + lateness (the reference registers
            # cleanup timers whatever the trigger); processing-time windows
            # fire on the runtime's tick (on_processing_time)
            self.flush_pipeline()
            if (self.trigger.fires_on_count
                    and not isinstance(self.assigner, GlobalWindows)
                    and self._leaves is not None
                    and self.pane_base is not None):
                self._expire_panes(self.watermark)
            return []
        return self._advance_time(self.watermark)

    def on_processing_time(self, timestamp_ms: int) -> List[StreamElement]:
        """The runtime's processing-time tick: processing-time windows whose
        end it passed fire (``ProcessingTimeTrigger``); monotone, so a
        clock stepped back never rewinds it."""
        self._proc_time = max(self._proc_time, int(timestamp_ms))
        if self.assigner.is_event_time or not self.trigger.fires_on_time:
            return []
        return self._advance_time(self._proc_time)

    def _now_ms(self) -> int:
        """Processing time of a batch's records: the clock seam's wall
        clock (``utils/clock.py``)."""
        return clock.now_ms()

    def prepare_snapshot_pre_barrier(self) -> List[StreamElement]:
        """Advance the staged batches and drain every pending async fire, so
        its rows travel downstream before the barrier; after this
        :meth:`snapshot_state` is legal, ``async_fire`` included.  Also the
        checkpoint-aligned safe point of device-lane healing: a degraded
        operator whose monitor probed healthy re-promotes here
        (:meth:`_maybe_repromote`), so the snapshot that follows is the
        card's and no barrier sees half-migrated state."""
        self.flush_pipeline()
        self._maybe_repromote()
        if self.async_fire:
            return self.drain_pending_fires(force=True)
        return []

    def end_input(self) -> List[StreamElement]:
        """Bounded input: fire everything outstanding (and drain the async
        fires that this starts).  GlobalWindows under a time-firing trigger
        fire every key at the end of input; NeverTrigger and partial count
        windows emit nothing, as in the reference, where a trailing partial
        ``countWindow`` is dropped."""
        if isinstance(self.assigner, GlobalWindows):
            self.flush_pipeline()
            pending = self.drain_pending_fires() if self.async_fire else []
            if self.trigger.fires_on_time:
                return pending + self._fire_by_count(force=True)
            return pending
        out = self._advance_time(2 ** 62)
        if self.async_fire:
            out.extend(self.drain_pending_fires(force=True))
        return out

    def _advance_time(self, now: int) -> List[StreamElement]:
        self.flush_pipeline()       # fires and expiry below read state
        # async fires of earlier calls surface before any new ones
        out: List[StreamElement] = (self.drain_pending_fires()
                                    if self.async_fire else [])
        if self.pane_base is None or (self._leaves is None
                                      and not self._degraded):
            return out
        a = self.assigner
        if isinstance(a, GlobalWindows):   # no time-bounded panes to fire
            return out
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
        if (self.device_sync_mode == "deferred" or self._degraded
                or self._leaves is None):
            # no in-line device write: the next device_refresh (or
            # re-promotion) rebuilds the whole ring (identity where no live
            # pane), subsuming this clear
            self._device_stale = True
        else:
            self._clear_panes_step(torch.from_numpy(
                np.asarray(expired, np.int64) % self._P).to(self.device))
        for ep in expired:
            self._mirror.pop(ep, None)
            self._vmirror.pop(ep, None)
            if self._nm is not None:
                self._nm.drop_pane(ep)
        if self._pager is not None and not self._degraded:
            self._pager.drop_panes(expired)
        if self._delta_counts is not None and not self._degraded:
            # expired panes' unsynced delta is discarded with the mirror pane
            # it would have folded into
            dead = [q for q in expired if q in self._delta_panes]
            if dead:
                self._delta_clear_step(torch.from_numpy(
                    np.asarray(dead, np.int64) % self._P).to(self.device))
                self._delta_panes.difference_update(dead)
        if self.pane_base > self.max_pane:
            self.max_pane = self.pane_base
        if self._count_baselines or self._value_baselines:
            # count-trigger registers of windows wholly behind retention
            lo_w = self.assigner.windows_of_pane(self.pane_base)[0]
            for reg, drops in ((self._count_baselines, self._incr_cb_drops),
                               (self._value_baselines, self._incr_vb_drops)):
                for w in [w for w in reg if w < lo_w]:
                    del reg[w]
                    if self.incremental_state:
                        drops.add(w)

    # ------------------------------------------------------------------ fires
    def _fire_window(self, window_id: int) -> List[StreamElement]:
        # a degraded device tier serves its fires from the host value
        # mirror (no device op), with the host tier's pane combine
        degraded = self._degraded and self.emit_tier != "host"
        if self._leaves is None and not degraded:
            return []
        first, last = self.assigner.window_panes(window_id)
        if last < self.pane_base or first > self.max_pane:
            return []
        panes = np.arange(max(first, self.pane_base),
                          min(last, self.max_pane) + 1, dtype=np.int64)
        with self._phase("fire"):
            if self.emit_tier == "host" or degraded:
                return self._fire_window_host(window_id, panes)
            if self.sharding is not None and self._pager is None:
                # no emit mirror: every block's rows over the window's
                # panes, unclipped as in JAX
                return self._fire_window_full(
                    window_id, np.arange(first, last + 1, dtype=np.int64))
            out = self._fire_window_gather(window_id, panes)
            if self._pager is not None:
                # spilled keys are first-class in fires: their cells upload
                # and run the same pane combine, after the resident keys
                out = out + self._fire_window_spilled(window_id, panes)
            return out

    def _fire_gather_step(self, pane_slots: torch.Tensor,
                          idx: torch.Tensor, leaves=None):
        """Fire for a host-known emit set: gather the ``idx`` key rows'
        window panes (``[n, len(panes)]`` cells of every leaf; of
        ``leaves``, one row block, where given), combine the panes in JAX's
        pairwise order, ``get_result``."""
        cells = (idx.to(torch.int64).unsqueeze(1) * self._P
                 + pane_slots.unsqueeze(0))
        sel = tuple(l.reshape(-1).take(cells)
                    for l in (self._leaves if leaves is None else leaves))
        combined = combine_along_axis(sel, self.agg.combine_leaves, axis=1)
        return self.agg.get_result(self.spec.unflatten(combined))

    def _fire_gather_blocks(self, panes: np.ndarray, idx: np.ndarray):
        """:meth:`_fire_gather_step` over sharded state (the paged mesh):
        each block gathers the emitted rows it holds, on its device; the
        results come together on the operator's device in ascending row
        order."""
        parts = []
        for lo, lb, cb in self._row_blocks(self._leaves, self._counts):
            sel = idx[(idx >= lo) & (idx < lo + cb.shape[0])] - lo
            if not sel.size:
                continue
            with self._on_device(cb.device):
                res = self._fire_gather_step(
                    torch.from_numpy(panes % self._P).to(cb.device),
                    self._ids_to_device(sel.astype(np.int32)).to(cb.device),
                    lb)
            parts.append([r.to(self.device) for r in tree_leaves(res)])
        return tree_unflatten(tree_structure(res),
                              [torch.cat(c) for c in zip(*parts)])

    def _k_active(self) -> int:
        """Live key rows a full-capacity fire reads (0: all of them).
        Sharded state reads every row: a slice would break the even split
        over the blocks."""
        if self.sharding is not None or self.key_index is None:
            return 0
        n = (self._pager.row_high_water if self._pager is not None
             else self.key_index.num_keys)
        ka = 4096
        while ka < n:
            ka <<= 2
        return min(ka, self._K)

    def _fire_step(self, pane_slots: np.ndarray, k_active: int):
        """The full-capacity fire (JAX's, for sharded state without an emit
        mirror): on each block, on its own device, gather the window's
        pane columns of the first ``k_active`` rows (0: every row), combine
        them in JAX's pairwise order, ``get_result``.  Returns one ``(mask,
        result)`` a block: mask = the rows with data in the window."""
        out = []
        for _, lb, cb in self._row_blocks(self._leaves, self._counts):
            rows = k_active or cb.shape[0]
            with self._on_device(cb.device):
                s = torch.from_numpy(pane_slots).to(cb.device)
                sel = tuple(l[:rows].index_select(1, s) for l in lb)
                total = cb[:rows].index_select(1, s).sum(dim=1)
                combined = combine_along_axis(sel, self.agg.combine_leaves,
                                              axis=1)
                out.append((total > 0, self.agg.get_result(
                    self.spec.unflatten(combined))))
        return out

    def _fire_window_full(self, window_id: int,
                          panes: np.ndarray) -> List[StreamElement]:
        """Fire through :meth:`_fire_step` and :meth:`_emit`."""
        return self._emit(self._fire_step(panes % self._P, self._k_active()),
                          self.assigner.window_bounds(window_id))

    def _emit(self, blocks, window,
              host_mask: Optional[np.ndarray] = None) -> List[StreamElement]:
        """Rows of a full-capacity fire, in ascending slot order: each
        block's mask over its live keys and its results at the masked rows
        come down (one download each); the keys resolve on the host.  A
        ``host_mask`` over the rows (a count fire's, computed on the host)
        replaces the blocks' masks and is not downloaded."""
        n = self.key_index.num_keys
        idx, res, structure, lo = [], [], None, 0
        for mask, result in blocks:
            rows = min(mask.shape[0], n - lo)
            if rows > 0:
                if host_mask is not None:
                    mask_np = host_mask[lo:lo + rows]
                    m = torch.from_numpy(mask_np).to(mask.device)
                else:
                    m = mask[:rows]
                    mask_np = m.cpu().numpy()
                vals = [l[:rows][m].cpu().numpy()
                        for l in tree_leaves(result)]
                self.phase_bytes["d2h"] = (self.phase_bytes.get("d2h", 0)
                                           + mask_np.nbytes
                                           + sum(v.nbytes for v in vals))
                idx.append(np.flatnonzero(mask_np) + lo)
                res.append(vals)
            structure = tree_structure(result)
            lo += mask.shape[0]
        if not idx or not sum(i.size for i in idx):
            return []
        out = tree_unflatten(structure, [np.concatenate(c)
                                         for c in zip(*res)])
        return self._rows_for(np.concatenate(idx), out, window)

    # ------------------------------------------------------- count triggers
    def _count_column(self, pane_slots: np.ndarray, ka: int) -> np.ndarray:
        """int64 ``[ka]``: the counts of the first ``ka`` key rows summed
        over ``pane_slots``, downloaded as int32 (JAX's count dtype), one
        column a block."""
        parts = []
        for lo, _, cb in self._row_blocks(self._leaves, self._counts):
            rows = min(cb.shape[0], ka - lo)
            if rows <= 0:
                break
            s = torch.from_numpy(pane_slots).to(cb.device)
            parts.append(cb[:rows].index_select(1, s).sum(
                dim=1, dtype=torch.int32).cpu().numpy())
        self.phase_bytes["d2h"] = (self.phase_bytes.get("d2h", 0)
                                   + sum(p.nbytes for p in parts))
        return np.concatenate(parts).astype(np.int64)

    @staticmethod
    def _grown(base: Optional[np.ndarray], ka: int) -> np.ndarray:
        """A count register at least ``ka`` long (new slots zero)."""
        if base is not None and len(base) >= ka:
            return base
        grown = np.zeros(ka, np.int64)
        if base is not None:
            grown[:len(base)] = base
        return grown

    def _fire_by_count(self, force: bool = False) -> List[StreamElement]:
        """GlobalWindows: fire the keys whose count reached the threshold
        (every key with data under ``force``, the end of input), then purge
        their rows when the trigger purges; a non-purging trigger tracks
        what it fired in the count baseline of window 0."""
        if self._leaves is None:
            return []
        thr = 1 if force else self.trigger.count_threshold
        ka = self._k_active() or self._K
        counts0 = self._count_column(np.zeros(1, np.int64), ka)
        base = None
        if not force and not self.trigger.purges_on_fire:
            # FIRE only: the state persists, so "n more elements" is
            # tracked by a baseline of already-fired counts per key
            old = self._count_baselines.get(0)
            base = self._count_baselines[0] = self._grown(old, ka)
            if self.incremental_state and base is not old:
                # a full snapshot packs the register from its creation on
                self._incr_cb_dirty.add(0)
            over = (counts0 - base[:ka]) >= thr
        else:
            over = counts0 >= thr
        if not over.any():     # skip the K-wide fire
            return []
        fired = over & (counts0 > 0)
        out = self._emit(self._fire_step(np.zeros(1, np.int64),
                                         self._k_active()),
                         self.assigner.window_bounds(0), fired)
        if base is not None:
            base[:ka] = np.where(fired, counts0, base[:ka])
            if self.incremental_state:
                self._incr_cb_dirty.add(0)
        if self.trigger.purges_on_fire and out:
            self._purge_keys_step(fired)
            for arr in self._mirror.values():   # whole key rows purged
                arr[:fired.size][fired[:arr.size]] = False
            # purged rows are identity in every retained pane now
            self._incr_mark_gids(np.flatnonzero(fired), self._live_panes())
        return out

    def _fire_count_in_panes(self, touched_panes) -> List[StreamElement]:
        """CountTrigger FIRE over time windows, after a batch: a purging
        trigger over tumbling windows (one pane a window) fires, per touched
        pane, the keys at or over the threshold and purges those cells;
        sliding windows and non-purging triggers go through the count
        baselines (:meth:`_fire_count_sliding`)."""
        if self.assigner.panes_per_window != 1 \
                or not self.trigger.purges_on_fire:
            return self._fire_count_sliding(touched_panes)
        out: List[StreamElement] = []
        thr = self.trigger.count_threshold
        ka = self._k_active() or self._K
        for p in np.asarray(touched_panes).tolist():
            slots = np.asarray([int(p) % self._P], np.int64)
            col = self._count_column(slots, ka)
            over = col >= thr
            if not over.any():
                continue
            fired = over & (col > 0)
            window = self.assigner.window_bounds(
                self.assigner.windows_of_pane(int(p))[0])
            out.extend(self._emit(self._fire_step(slots, self._k_active()),
                                  window, fired))
            self._purge_cells_step(fired, slots)
            marr = self._mirror.get(int(p))
            if marr is not None:
                marr[:fired.size][fired[:marr.size]] = False
            self._incr_mark_gids(np.flatnonzero(fired), [int(p)])
        return out

    def _fire_count_sliding(self, touched_panes) -> List[StreamElement]:
        """CountTrigger FIRE for sliding windows, or any non-purging count
        trigger: a (key, window) fires when the sum of the window's pane
        counts grew by >= n since its last fire; the per-(key, window)
        baseline is the CountTrigger count register, which clears on FIRE.
        A purge over sliding windows is logical: the fired accumulator is
        kept as a value baseline and subtracted from later emissions
        (:meth:`_emit_purging_sliding`), so the shared pane cells stay."""
        out: List[StreamElement] = []
        thr = self.trigger.count_threshold
        purging = self.trigger.purges_on_fire
        ka = self._k_active() or self._K
        wins: set = set()
        for p in np.asarray(touched_panes).tolist():
            w0, w1 = self.assigner.windows_of_pane(int(p))
            wins.update(range(w0, w1 + 1))
        for w in sorted(wins):
            first, last = self.assigner.window_panes(w)
            lo, hi = max(first, self.pane_base), min(last, self.max_pane)
            if lo > hi:
                continue
            slots = np.arange(lo, hi + 1, dtype=np.int64) % self._P
            counts_w = self._count_column(slots, ka)
            base = self._grown(self._count_baselines.get(w), ka)
            over = (counts_w - base[:ka]) >= thr
            if over.any():
                if purging:
                    out.extend(self._emit_purging_sliding(w, slots, ka,
                                                          over))
                else:
                    out.extend(self._emit(
                        self._fire_step(slots, self._k_active()),
                        self.assigner.window_bounds(w),
                        over & (counts_w > 0)))
                base[:ka] = np.where(over, counts_w, base[:ka])
            self._count_baselines[w] = base
            if self.incremental_state:
                # the register exists (zero-grown included): a full
                # snapshot would pack it, so the increment ships it too
                self._incr_cb_dirty.add(w)
        return out

    def _fire_acc_step(self, pane_slots: np.ndarray,
                       k_active: int) -> List[np.ndarray]:
        """:meth:`_fire_step` before ``get_result``: the window's combined
        accumulator leaves of the first ``k_active`` rows (0: every row),
        downloaded, blocks in row order."""
        parts = []
        for _, lb, cb in self._row_blocks(self._leaves, self._counts):
            rows = k_active or cb.shape[0]
            with self._on_device(cb.device):
                s = torch.from_numpy(pane_slots).to(cb.device)
                sel = tuple(l[:rows].index_select(1, s) for l in lb)
                parts.append([c.cpu().numpy() for c in combine_along_axis(
                    sel, self.agg.combine_leaves, axis=1)])
        return [np.concatenate(c) for c in zip(*parts)]

    def _emit_purging_sliding(self, w: int, slots: np.ndarray, ka: int,
                              over: np.ndarray) -> List[StreamElement]:
        """One FIRE_AND_PURGE over sliding window ``w``: download the
        combined accumulator, subtract the value baseline (what was already
        fired and purged), emit, and advance the baseline of the fired
        keys."""
        comb = self._fire_acc_step(slots, self._k_active())
        self.phase_bytes["d2h"] = (self.phase_bytes.get("d2h", 0)
                                   + sum(c.nbytes for c in comb))
        vb = self._value_baselines.get(w)
        if vb is None or vb[0].shape[0] < ka:
            grown = [np.zeros_like(c) for c in comb]
            if vb is not None:
                for g, o in zip(grown, vb):
                    g[:o.shape[0]] = o
            vb = grown
        emit_leaves = [c - b[:ka] for c, b in zip(comb, vb)]
        result = self.agg.get_result(self.spec.unflatten(
            [torch.from_numpy(np.ascontiguousarray(l))
             for l in emit_leaves]))
        idx = np.flatnonzero(over[:self.key_index.num_keys])
        out = []
        if idx.size:
            picked = tree_unflatten(tree_structure(result), [
                r.numpy()[idx] for r in tree_leaves(result)])
            out = self._rows_for(idx, picked, self.assigner.window_bounds(w))
        for b, c in zip(vb, comb):
            sel = over.reshape((-1,) + (1,) * (b.ndim - 1))
            b[:ka] = np.where(sel, c, b[:ka])
        self._value_baselines[w] = vb
        if self.incremental_state:
            self._incr_vb_dirty.add(w)
        return out

    def _purge_keys_step(self, fired: np.ndarray) -> None:
        """FIRE_AND_PURGE by key (GlobalWindows): the ``fired`` rows (a
        bool mask over the first rows) back to identity in every pane, in
        place."""
        inits = self.spec.leaf_inits
        for lo, lb, cb in self._row_blocks(self._leaves, self._counts):
            rows = np.flatnonzero(fired[lo:lo + cb.shape[0]])
            if rows.size:
                reset_rows(lb, cb, torch.from_numpy(rows).to(cb.device),
                           inits)

    def _purge_cells_step(self, fired: np.ndarray,
                          pane_slots: np.ndarray) -> None:
        """FIRE_AND_PURGE by cell (tumbling windows): the ``fired`` rows'
        cells at ``pane_slots`` back to identity, in place."""
        inits = [np.asarray(i).item() for i in self.spec.leaf_inits]
        for lo, lb, cb in self._row_blocks(self._leaves, self._counts):
            rows = np.flatnonzero(fired[lo:lo + cb.shape[0]])
            if not rows.size:
                continue
            at = (torch.from_numpy(rows).to(cb.device).unsqueeze(1),
                  torch.from_numpy(pane_slots).to(cb.device).unsqueeze(0))
            for l, init in zip(lb, inits):
                l[at] = init
            cb[at] = 0

    def _fire_window_gather(self, window_id: int,
                            panes: np.ndarray) -> List[StreamElement]:
        """Device-tier fire: the exact emit set from the host emit mirror,
        uploaded as int32; one gather step; one download of the result
        values (started here, collected now or, with ``async_fire``, by a
        later :meth:`drain_pending_fires`).  The keys resolve now (paged:
        through the rows' current tenants)."""
        idx = self._mirror_emit_idx(panes)
        if idx.size == 0:
            return []
        if self.sharding is None:
            result = self._fire_gather_step(
                torch.from_numpy(panes % self._P).to(self.device),
                self._ids_to_device(idx.astype(np.int32)))
        else:
            result = self._fire_gather_blocks(panes, idx)
        handle = _fetch_enqueue(tree_leaves(result))
        if self._pager is not None:
            # rows -> global ids NOW: by the time an async fire drains, a
            # row may have been evicted and reassigned to another key
            idx = self._pager.gid_of[idx]
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

    # ------------------------------------------------------------- paging
    def _live_panes(self) -> np.ndarray:
        return np.arange(self.pane_base, self.max_pane + 1, dtype=np.int64)

    def _host_ids(self, arr: np.ndarray, device=None) -> torch.Tensor:
        """Row or pane-slot ids for an indexing step on ``device`` (the
        operator's by default)."""
        return torch.from_numpy(np.ascontiguousarray(arr, np.int64)).to(
            self.device if device is None else device)

    def _rows_by_block(self, rows: np.ndarray):
        """For each row block holding any of the global ``rows``: (leaf
        blocks, count block, positions in ``rows``, block-local rows)."""
        for lo, lb, cb in self._row_blocks(self._leaves, self._counts):
            sel = np.flatnonzero((rows >= lo) & (rows < lo + cb.shape[0]))
            if sel.size:
                yield lb, cb, sel, rows[sel] - lo

    def _page_slots(self, gids: np.ndarray) -> np.ndarray:
        """Map global key ids to resident ring rows, evicting cold keys and
        promoting/initializing missing ones.  At most one page-out gather
        and one page-in set per micro-batch.  The batch's rows are protected
        from the OOM page-out (``_active_rows``)."""
        pager = self._pager
        pager.ensure_gids(self.key_index.num_keys)
        uniq = np.unique(gids)
        rows_u = pager.rows(uniq)
        missing = uniq[rows_u < 0]
        if missing.size:
            live = self._live_panes()
            n_evict = int(missing.size) - pager.free_count()
            if n_evict > 0:
                victims = pager.pick_victims(n_evict, rows_u[rows_u >= 0])
                counts, leaves = self._gather_rows(victims, live)
                bits = self._mirror_bits_rows(victims, live)
                pager.spill_rows(victims, live, counts, leaves, bits)
                self._clear_mirror_rows(victims)
            rows_new, recycled = pager.assign_rows(missing)
            if pager.any_spilled(missing, live):
                counts_cols, leaf_cols, bits, _found = pager.load_entries(
                    missing, live, delete=True)
                self._page_in(rows_new, live, counts_cols, leaf_cols)
                for j, p in enumerate(live.tolist()):
                    hit = bits[:, j]
                    if hit.any():
                        self._mirror_mark(int(p), rows_new[hit])
            elif recycled:
                # recycled rows carry the previous tenant's stale cells:
                # reset them even when nothing was promoted from spill
                for lb, cb, _sel, local in self._rows_by_block(rows_new):
                    reset_rows(lb, cb, self._host_ids(local, cb.device),
                               self.spec.leaf_inits)
        rows = pager.rows(gids)
        self._active_rows = pager.rows(uniq)
        pager.touch(self._active_rows)
        return rows

    def _gather_rows(self, rows: np.ndarray, panes: np.ndarray,
                     bytes_key: str = "d2h_page_out"):
        """Download the ``rows x panes`` cell grid (page-out, or a paged
        snapshot's resident rows under ``bytes_key="d2h"``): (counts [V, m],
        leaves [V, m, *leaf]) as numpy."""
        counts = np.empty((rows.size, panes.size), np.int32)
        leaves = [np.empty((rows.size, panes.size) + tuple(shape), d)
                  for shape, d in zip(self.spec.leaf_shapes,
                                      self.spec.leaf_dtypes)]
        for lb, cb, sel, local in self._rows_by_block(rows):
            c, ls = gather_row_pane_columns(
                lb, cb, self._host_ids(local, cb.device),
                self._host_ids(panes % self._P, cb.device))
            counts[sel] = c.cpu().numpy()
            for dst, l in zip(leaves, ls):
                dst[sel] = l.cpu().numpy()
        self.phase_bytes[bytes_key] = (self.phase_bytes.get(bytes_key, 0)
                                       + counts.nbytes
                                       + sum(l.nbytes for l in leaves))
        return counts, leaves

    def _page_in(self, rows: np.ndarray, panes: np.ndarray,
                 counts_cols: np.ndarray, leaf_cols) -> None:
        """Upload promoted cells into freshly assigned rows (whole rows
        reset first — recycled rows carry the previous tenant's cells)."""
        for lb, cb, sel, local in self._rows_by_block(rows):
            cc = torch.from_numpy(np.ascontiguousarray(
                counts_cols[sel])).to(cb.device)
            lc = [torch.from_numpy(np.ascontiguousarray(c[sel])).to(
                cb.device) for c in leaf_cols]
            set_row_pane_columns(lb, cb, self._host_ids(local, cb.device),
                                 self._host_ids(panes % self._P, cb.device),
                                 lc, cc, self.spec.leaf_inits)
            self.phase_bytes["h2d_page_in"] = (
                self.phase_bytes.get("h2d_page_in", 0) + cc.nbytes
                + sum(l.nbytes for l in lc))

    def _mirror_bits_rows(self, rows: np.ndarray,
                          panes: np.ndarray) -> np.ndarray:
        """Emit-mirror bits of the ``rows x panes`` grid (spilled alongside
        counts so promotion restores the exact emit set)."""
        out = np.zeros((rows.size, panes.size), bool)
        for j, p in enumerate(panes.tolist()):
            arr = self._mirror.get(int(p))
            if arr is not None:
                out[:, j] = arr[rows]
        return out

    def _clear_mirror_rows(self, rows: np.ndarray) -> None:
        for arr in self._mirror.values():
            arr[rows] = False

    def _spill_fire_step(self, counts_cols: torch.Tensor, leaf_cols):
        """Window fire over UPLOADED spilled cells: the same pane combine +
        ``get_result`` the resident gather fire runs (same dtypes, same tree
        order over the same pane axis), so a key's emitted value does not
        depend on which tier held it."""
        total = counts_cols.sum(dim=1)
        combined = combine_along_axis(leaf_cols, self.agg.combine_leaves,
                                      axis=1)
        result = self.agg.get_result(self.spec.unflatten(combined))
        return total > 0, result

    def _fire_window_spilled(self, window_id: int,
                             panes: np.ndarray) -> List[StreamElement]:
        """Fire contribution of COLD keys: load their spilled cells for the
        window's panes, upload them as dense columns, combine on the device,
        download the results.  Chunks of 2^14 keys bound the memory at any
        spilled cardinality; synchronous even under ``async_fire``, as in
        JAX."""
        pager = self._pager
        gids = pager.spilled_gids(panes)
        if gids.size == 0:
            return []
        out: List[StreamElement] = []
        window = self.assigner.window_bounds(window_id)
        reverse = np.asarray(self.key_index.reverse_keys())
        CH = 1 << 14
        for lo in range(0, int(gids.size), CH):
            g = gids[lo: lo + CH]
            counts, leaves, _bits, _found = pager.load_entries(
                g, panes, delete=False)
            cc = torch.from_numpy(counts).to(self.device)
            lc = tuple(torch.from_numpy(l).to(self.device) for l in leaves)
            self.phase_bytes["h2d"] = (self.phase_bytes.get("h2d", 0)
                                       + cc.nbytes
                                       + sum(l.nbytes for l in lc))
            mask, result = self._spill_fire_step(cc, lc)
            mask_np = mask.cpu().numpy()
            idx = np.flatnonzero(mask_np)
            if idx.size == 0:
                continue
            res_np = [l.cpu().numpy()[idx] for l in tree_leaves(result)]
            self.phase_bytes["d2h"] = (self.phase_bytes.get("d2h", 0)
                                       + mask_np.nbytes
                                       + sum(a.nbytes for a in res_np))
            out.extend(self._rows_for_keys(
                reverse[g[idx]], tree_unflatten(tree_structure(result),
                                                res_np), window))
        return out

    def paging_stats(self) -> Optional[Dict[str, int]]:
        """Occupancy + eviction/promotion counters, or None when paging is
        off.  No barrier: staged batches are not advanced for it."""
        if self._pager is None:
            return None
        n = self.key_index.num_keys if self.key_index is not None else 0
        return self._pager.stats(n)

    def _paged_snapshot_rows(self, n: int, panes: np.ndarray,
                             bytes_key: str = "d2h"):
        """Dense gid-indexed snapshot arrays merging both tiers: counts
        int32 [n, m] + one [n, m, *leaf] per ACC leaf; the resident rows in
        one gather (booked under ``bytes_key``), the spilled cells filled
        in from the store."""
        m = int(panes.size)
        counts = np.zeros((n, m), np.int32)
        leaves = identity_grid(self.spec, n, m)
        rows, gids = self._pager.resident_pairs()
        if rows.size:
            res_counts, res_leaves = self._gather_rows(rows, panes,
                                                       bytes_key)
            counts[gids] = res_counts
            for dst, src in zip(leaves, res_leaves):
                dst[gids] = src
        self._pager.fill_snapshot(counts, leaves, panes)
        return counts, leaves

    def _paged_restore_rows(self, n: int, panes: np.ndarray,
                            counts_np: np.ndarray, leaves_np) -> None:
        """Restore a dense snapshot at THIS operator's K_cap: the first
        ``min(n, K_cap)`` keys become resident rows ``0..R-1`` (one upload),
        the overflow pages straight into the spill tier — a snapshot written
        at any capacity, paged or resident, restores at any other.  Runs
        after :meth:`restore_state` reset the pager and the emit mirror."""
        pager = self._pager
        pager.ensure_gids(max(n, 1))
        R = min(n, self._K)
        if R:
            pager.assign_rows(np.arange(R, dtype=np.int64))
            self._upload_columns(panes, counts_np[:R], leaves_np)
        if n > R:
            pager.import_rows(np.arange(R, n, dtype=np.int64), panes,
                              counts_np, leaves_np)

    def _upload_columns(self, panes: np.ndarray, counts_np: np.ndarray,
                        leaves_np) -> None:
        """Set the ring's first ``rows`` key rows x ``panes`` from dense
        host columns (counts ``[rows, m]``; each leaf's first ``rows`` rows),
        in place; on the device tier, mark the cells holding data in the
        emit mirror.  Restores and re-promotion."""
        self._set_columns(self._leaves, self._counts, panes % self._P,
                          counts_np, leaves_np)
        if self.emit_tier == "device":
            for j, p in enumerate(panes.tolist()):
                nz = np.flatnonzero(counts_np[:, j] > 0)
                if nz.size:
                    self._mirror_mark(int(p), nz)

    # -------------------------------------------------------------- snapshots
    # ------------------------------------ incremental (delta) checkpoints
    def _incr_clear(self) -> None:
        """Reset all delta tracking: the next cut must be a full re-base
        (restore, reset: any point where the link from the confirmed base
        to the stored increment chain is cut)."""
        self._incr_keychunks: List = []       # live (raw keys, panes) pairs
        self._incr_gid_cells: Dict[int, List[np.ndarray]] = {}  # pane->gids
        self._incr_cb_dirty: set = set()
        self._incr_vb_dirty: set = set()
        self._incr_cb_drops: set = set()
        self._incr_vb_drops: set = set()
        #: cuts taken but not yet confirmed: [(cid, cells, cbd, vbd,
        #: cb_drops, vb_drops, num_keys_at_cut)]; every later cut ships the
        #: union of these with the live dirt, so a crash between a cut and
        #: its confirmation never loses a mutation
        self._incr_unconfirmed: List = []
        self._incr_last_confirmed: Optional[int] = None
        self._incr_confirmed_n = 0

    def _incr_mark_batch(self, keys: np.ndarray, panes: np.ndarray) -> None:
        self._incr_keychunks.append((np.array(keys, copy=True),
                                     np.array(panes, copy=True)))
        if len(self._incr_keychunks) > 512:
            # bound the live memory between cuts: coalesce into the key-id
            # map, once the staged and in-flight batches hold their ids
            self.flush_pipeline()
            self._incr_coalesce_live()

    def _incr_mark_gids(self, gids: np.ndarray, panes) -> None:
        """Product mark: every (key id, pane) cell of gids x panes is
        dirty."""
        if not self.incremental_state or len(gids) == 0:
            return
        g = np.asarray(gids, np.int64).copy()
        for p in np.asarray(panes).tolist():
            self._incr_gid_cells.setdefault(int(p), []).append(g)

    def _incr_coalesce_live(self) -> None:
        """Resolve the live raw-key chunks to key ids, into the cell map."""
        chunks, self._incr_keychunks = self._incr_keychunks, []
        if self.key_index is None:
            return
        for keys, panes in chunks:
            gids = np.asarray(self.key_index.lookup(keys), np.int64)
            ok = gids >= 0
            if not ok.all():
                gids, panes = gids[ok], panes[ok]
            if not gids.size:
                continue
            p0, p1 = int(panes.min()), int(panes.max())
            for p in (range(p0, p1 + 1) if p1 - p0 < 64
                      else np.unique(panes).tolist()):
                g = gids[panes == p]
                if g.size:
                    self._incr_gid_cells.setdefault(int(p), []).append(g)

    def _incr_freeze(self, cid: int) -> None:
        """Move the live dirt into the unconfirmed ledger under ``cid``."""
        self._incr_coalesce_live()
        cells = {p: _distinct_ids(lst)
                 for p, lst in self._incr_gid_cells.items()}
        n = self.key_index.num_keys if self.key_index is not None else 0
        self._incr_unconfirmed.append(
            (cid, cells, self._incr_cb_dirty, self._incr_vb_dirty,
             self._incr_cb_drops, self._incr_vb_drops, n))
        self._incr_gid_cells = {}
        self._incr_cb_dirty, self._incr_vb_dirty = set(), set()
        self._incr_cb_drops, self._incr_vb_drops = set(), set()

    def _incremental_snapshot(self, cid: int) -> Optional[Dict[str, Any]]:
        """A ``window_delta`` increment covering every mutation since the
        last confirmed cut, or None when this cut must be a full re-base
        (no confirmed base yet, or a grid too dirty for a delta to pay).
        Either way the live dirt is frozen under ``cid``, so the next cut
        keeps covering it until confirmation."""
        self._incr_freeze(cid)
        base_n = self._incr_confirmed_n
        if self._incr_last_confirmed is None or self.key_index is None:
            return None
        n = self.key_index.num_keys
        # the union of all unconfirmed dirt (absolute values: replaying a
        # superset, last writer wins, is harmless)
        union: Dict[int, List[np.ndarray]] = {}
        cbd: set = set()
        vbd: set = set()
        cb_drops: set = set()
        vb_drops: set = set()
        for (_c, ecells, ecbd, evbd, ecbdrop, evbdrop, _n) \
                in self._incr_unconfirmed:
            for p, g in ecells.items():
                union.setdefault(int(p), []).append(g)
            cbd |= ecbd
            vbd |= evbd
            cb_drops |= ecbdrop
            vb_drops |= evbdrop
        cells_map: Dict[int, np.ndarray] = {}
        for p, lst in union.items():
            if self.pane_base is not None and \
                    not (self.pane_base <= p <= self.max_pane):
                continue            # the pane expired since it was marked
            g = lst[0] if len(lst) == 1 else _distinct_ids(lst)
            g = np.asarray(g, np.int64)
            g = g[g < n]
            if g.size:
                cells_map[int(p)] = g
        has_grid = (self._leaves is not None or self._degraded) \
            and self.pane_base is not None
        if has_grid:
            m = int(self.max_pane - self.pane_base + 1)
            dirty_cells = sum(int(g.size) for g in cells_map.values())
            if n and m and dirty_cells > self.incr_rebase_ratio * n * m:
                return None          # too dirty: re-base with a full cut
        inc: Dict[str, Any] = {
            "__increment__": 1, "kind": "window_delta",
            "checkpoint_id": cid, "n": n, "base_n": base_n,
            "has_grid": has_grid,
            "meta": {"pane_base": self.pane_base, "max_pane": self.max_pane,
                     "last_fired_window": self.last_fired_window,
                     "watermark": self.watermark,
                     "late_dropped": self.late_dropped, "P": self._P},
            "key_index_kind": key_index_kind(self.key_index),
            "key_tail": np.asarray(
                self.key_index.reverse_keys()[base_n:n]).copy(),
        }
        cell_list: List[Dict[str, Any]] = []
        if has_grid and cells_map:
            dirty_panes = sorted(cells_map)
            panes_arr = np.asarray(dirty_panes, np.int64)
            with self._phase("snapshot"):
                if self.snapshot_source == "mirror" or self._degraded:
                    counts, leaves = self._mirror_columns(dirty_panes, n)
                    rows = None
                elif self._pager is not None:
                    counts, leaves = self._paged_snapshot_rows(
                        n, panes_arr, "d2h_page_out")
                    rows = None
                else:
                    # the device tier: one gather of the dirty rows x dirty
                    # panes, so the download follows the dirt, not the state
                    rows = _distinct_ids([cells_map[p] for p in dirty_panes])
                    counts, leaves = self._gather_rows(rows, panes_arr)
            for j, p in enumerate(dirty_panes):
                g = cells_map[p]
                idx = g if rows is None else np.searchsorted(rows, g)
                cell_list.append(
                    {"pane": p, "gids": g,
                     "counts": counts[idx, j].copy(),
                     "leaves": [l[idx, j].copy() for l in leaves]})
        inc["cells"] = cell_list
        if has_grid:
            inc["leaf_meta"] = [
                (np.asarray(init, np.dtype(d)), str(np.dtype(d)),
                 tuple(shape))
                for init, shape, d in zip(self.spec.leaf_inits,
                                          self.spec.leaf_shapes,
                                          self.spec.leaf_dtypes)]
            inc["leaf_schema"] = acc_leaf_schema(self.spec)
        else:
            inc["leaf_meta"] = []
        if self._pager is not None:
            inc["paging_stats"] = self._pager.stats(n)
        cb_vals: Dict[int, np.ndarray] = {}
        for w in cbd:
            b = self._count_baselines.get(w)
            if b is None:
                cb_drops.add(w)
            else:
                cb_vals[w] = np.asarray(b, np.int64).copy()
        vb_vals: Dict[int, List[np.ndarray]] = {}
        for w in vbd:
            ls = self._value_baselines.get(w)
            if ls is None:
                vb_drops.add(w)
            else:
                vb_vals[w] = [np.asarray(l).copy() for l in ls]
        inc["count_baselines"] = cb_vals
        inc["value_baselines"] = vb_vals
        inc["cb_drops"] = sorted(cb_drops)
        inc["vb_drops"] = sorted(vb_drops)
        return inc

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        """Tags the last completed checkpoint for the queryable view. Delta
        tracking: the dirt up to a confirmed cut may be forgotten, for cuts
        this operator froze only (savepoints and final snapshots are not
        links of the stored increment chain and never advance it)."""
        if self._last_completed_checkpoint is None \
                or checkpoint_id > self._last_completed_checkpoint:
            self._last_completed_checkpoint = checkpoint_id
        match = next((e for e in self._incr_unconfirmed
                      if e[0] == checkpoint_id), None)
        if match is not None:
            self._incr_unconfirmed = [e for e in self._incr_unconfirmed
                                      if e[0] > checkpoint_id]
            self._incr_last_confirmed = checkpoint_id
            self._incr_confirmed_n = match[6]
        super().notify_checkpoint_complete(checkpoint_id)

    def queryable_view(self):
        """The live-read view (``queryable/view.WindowReadView``) when this
        operator was built with ``queryable=<name>``, else None. Reading it
        takes no barrier."""
        return self._qview

    @staticmethod
    def split_snapshot(snap: Dict[str, Any], max_parallelism: int,
                       new_parallelism: int) -> List[Dict[str, Any]]:
        """Rescale a snapshot across key-group ranges
        (``StateAssignmentOperation.reDistributeKeyedStates``); a mesh
        snapshot's slices are densified first."""
        snap = densify_keyed_snapshot(snap)
        snap, extra = WindowAggOperator._pack_baselines(snap)
        parts = split_keyed_snapshot(snap,
                                     WindowAggOperator.ROW_FIELDS + extra,
                                     max_parallelism, new_parallelism)
        return [WindowAggOperator._unpack_baselines(p) for p in parts]

    @staticmethod
    def _pack_baselines(snap: Dict[str, Any],
                        windows: Optional[List[int]] = None):
        """The count baselines (window -> slot-row array) as a list-valued
        row field aligned on ``windows`` (zeros where this snapshot lacks a
        window), so the redistribution splits and concatenates them by row
        like the leaves.  Returns ``(snapshot, extra row fields)``."""
        snap = dict(snap)
        cb = snap.pop("count_baselines", None) or {}
        if windows is None:
            if not cb:
                return snap, ()
            windows = sorted(cb)
        n = next((len(np.asarray(v)) for v in cb.values()),
                 snap["counts"].shape[0] if "counts" in snap else 0)
        snap["count_baseline_windows"] = list(windows)
        snap["count_baseline_rows"] = [
            np.asarray(cb.get(w, np.zeros(n, np.int64))) for w in windows]
        return snap, ("count_baseline_rows",)

    @staticmethod
    def _unpack_baselines(snap: Dict[str, Any]) -> Dict[str, Any]:
        wins = snap.pop("count_baseline_windows", None)
        rows = snap.pop("count_baseline_rows", None)
        if wins:
            snap["count_baselines"] = dict(zip(wins, rows))
        return snap

    @staticmethod
    def merge_snapshots(snaps: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Merge the snapshots of one checkpoint's subtasks (scale-down).
        Their keys are disjoint (key-group partitioned); parts whose pane
        progress differs (an unaligned checkpoint) are first expanded onto
        the union pane range, and the merge resumes from the slowest part's
        watermark and last fired window, as in JAX."""
        snaps = [densify_keyed_snapshot(s) for s in snaps]
        live = [s for s in snaps if "panes" in s]
        if live and any(not np.array_equal(s["panes"], live[0]["panes"])
                        for s in live[1:]):
            snaps = WindowAggOperator._align_pane_progress(snaps)
            live = [s for s in snaps if "panes" in s]
        all_windows = sorted({w for s in snaps
                              for w in (s.get("count_baselines") or {})})
        extra = ()
        if all_windows:
            packed = []
            for s in snaps:
                p, e = WindowAggOperator._pack_baselines(s, all_windows)
                packed.append(p)
                extra = e or extra
            snaps = packed
        merged = WindowAggOperator._unpack_baselines(merge_keyed_snapshots(
            snaps, WindowAggOperator.ROW_FIELDS + extra))
        if live:
            merged["watermark"] = min(s["watermark"] for s in live)
            lf = [s.get("last_fired_window") for s in live]
            merged["last_fired_window"] = (None if any(w is None for w in lf)
                                           else min(lf))
        return merged

    @staticmethod
    def _align_pane_progress(snaps: List[Dict[str, Any]]
                             ) -> List[Dict[str, Any]]:
        """Expand each part's pane-indexed row fields onto the union pane
        range (zero cells where a part expired or never reached a pane, as
        JAX fills them); P grows to cover the union span."""
        live = [s for s in snaps if "panes" in s]
        base = min(int(s["pane_base"]) for s in live)
        top = max(int(s["max_pane"]) for s in live)
        union = np.arange(base, top + 1, dtype=np.int64)
        ring = max(int(s.get("P", 2)) for s in live)
        while ring < len(union):
            ring <<= 1
        out = []
        for s in snaps:
            if "panes" not in s:
                out.append(s)
                continue
            s2 = dict(s)
            off = int(s["pane_base"]) - base

            def widen(a):
                a = np.asarray(a)
                w = np.zeros((a.shape[0], len(union)) + a.shape[2:], a.dtype)
                w[:, off:off + a.shape[1]] = a
                return w
            s2["counts"] = widen(s["counts"])
            s2["leaves"] = [widen(l) for l in s["leaves"]]
            s2["panes"] = union
            s2["pane_base"] = base
            s2["max_pane"] = top
            s2["P"] = ring
            out.append(s2)
        return out

    def snapshot_state(self) -> Dict[str, Any]:
        """Dense numpy snapshot, served from the host mirror or, with
        ``snapshot_source="device"``, downloaded from the replica (paged:
        the resident rows downloaded, the spilled cells filled in from the
        store; the same gid-indexed format every way, and the JAX
        operator's, with ``paging_stats`` beside it when paged)."""
        self.flush_pipeline()       # the snapshot must hold staged batches
        if self._pending_fires:
            # a snapshot with undrained async fires could neither replay nor
            # hold those emissions: the runtime drains them first
            raise ValueError(
                "snapshot with in-flight async fires: the runtime must call "
                "prepare_snapshot_pre_barrier() (and forward its elements) "
                "before snapshot_state()")
        cid = current_checkpoint_id()
        if self.incremental_state and cid is not None \
                and snapshot_is_incremental():
            inc = self._incremental_snapshot(cid)
            if inc is not None:
                return inc
            # a full re-base cut: the dirt was frozen under cid, so its
            # confirmation advances the delta base to it
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
            snap["key_index_kind"] = key_index_kind(self.key_index)
        if (self._leaves is not None or self._degraded) \
                and self.pane_base is not None and self.key_index is not None:
            n = self.key_index.num_keys
            panes = np.arange(self.pane_base, self.max_pane + 1,
                              dtype=np.int64)
            snap["panes"] = panes
            with self._phase("snapshot"):
                # degraded: the host value mirror IS the state, in the same
                # dense gid-indexed format, so a checkpoint taken during a
                # quarantine restores on either tier
                if self.snapshot_source == "mirror" or self._degraded:
                    counts, leaves = self._mirror_columns(panes.tolist(), n)
                elif self._pager is not None:
                    counts, leaves = self._paged_snapshot_rows(n, panes)
                else:
                    counts, leaves = self._device_columns(panes, n)
            snap["leaves"] = leaves
            snap["counts"] = counts
            snap["leaf_schema"] = acc_leaf_schema(self.spec)
        if self._pager is not None:
            snap["paging_stats"] = self.paging_stats()
        if self._count_baselines:
            n = self.key_index.num_keys if self.key_index else 0
            packed = {}
            for w, b in self._count_baselines.items():
                arr = np.zeros(n, np.int64)  # slot-aligned with the leaves
                arr[:min(len(b), n)] = np.asarray(b)[:n]
                packed[w] = arr
            snap["count_baselines"] = packed
        if self._value_baselines:
            snap["value_baselines"] = {
                w: [np.asarray(l).copy() for l in leaves]
                for w, leaves in self._value_baselines.items()}
        return snap

    def _device_columns(self, panes: np.ndarray, rows: int):
        """The replica's live columns: counts int32 ``[rows, len(panes)]``
        and one ``[rows, len(panes)]`` array per leaf, each downloaded in one
        gather (live keys x live panes)."""
        counts, leaves = self._ring_columns(self._leaves, self._counts,
                                            panes % self._P, rows)
        self.phase_bytes["d2h"] = (self.phase_bytes.get("d2h", 0)
                                   + counts.nbytes
                                   + sum(l.nbytes for l in leaves))
        return counts, leaves

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self.flush_pipeline()
        # a mesh snapshot's per-shard slices merge into the dense layout:
        # restore at ANY mesh size (1 included) re-slices by this
        # operator's layout, not the writer's
        snap = densify_keyed_snapshot(snap)
        self.pane_base = snap["pane_base"]
        self.max_pane = snap["max_pane"]
        self.last_fired_window = snap["last_fired_window"]
        self.watermark = snap["watermark"]
        self.late_dropped = snap.get("late_dropped", 0)
        self._P = snap["P"]
        # restores land on the device tier; if the monitor is still
        # quarantined, the first dispatch migrates again (the snapshot
        # format is tier-agnostic)
        self._degraded = False
        self._cut_dispatches()
        self._active_rows = None
        self._writing = False
        self._dki = None         # probe table rebuilds from the key index
        self._drop_delta()
        self._incr_clear()       # restored state: the first cut is a base
        self._devprobe_resolved = None
        self._nm = None          # rebinds to the restored key index below
        if "key_index" in snap:
            self._bind_key_index(snap["key_index"],
                                 snap.get("key_index_kind", "KeyIndex"))
            # (a paged ring stays at its K_cap)
            self._K = self._round_key_capacity(
                max(self.key_index.num_keys, 1))
        else:
            self.key_index = None    # no keys yet: the next batch binds
        self._leaves = None
        self._counts = None
        self._vmirror = {}
        self._mirror = {}
        if self._pager is not None:
            self._pager.reset()
        # the count-trigger registers (a paged operator holds none: it
        # refuses count triggers, and JAX's paged restore drops them)
        self._count_baselines = {} if self._pager is not None else {
            w: np.asarray(b, np.int64).copy()
            for w, b in (snap.get("count_baselines") or {}).items()}
        self._value_baselines = {} if self._pager is not None else {
            w: [np.asarray(l).copy() for l in leaves]
            for w, leaves in (snap.get("value_baselines") or {}).items()}
        if "leaves" in snap:
            counts_np = np.asarray(snap["counts"])
            n = counts_np.shape[0]
            panes = np.asarray(snap["panes"], np.int64)

            def fill(j, _n=n, _np=len(panes)):
                # an ADDED accumulator field: identity rows [n, panes, ...]
                init = np.asarray(self.spec.leaf_inits[j],
                                  self.spec.leaf_dtypes[j])
                return np.broadcast_to(
                    init, (_n, _np) + tuple(self.spec.leaf_shapes[j])).copy()

            # leaves by field name: kept, widened, added or dropped as the
            # aggregate evolved (narrowing raises SchemaEvolutionError)
            restored = [np.asarray(l) for l in migrate_acc_leaves(
                snap["leaves"], snap.get("leaf_schema"), self.spec, fill)]
            # allocated either way, so time and fire guards see live state
            self._ensure_alloc()
            if self._pager is not None:
                # the resident prefix uploads, the overflow spills: works at
                # ANY K_cap relative to the snapshot's key count
                self._paged_restore_rows(n, panes, counts_np, restored)
                return
            # resolve the cadence NOW (a process-wide verdict may exist): a
            # deferred restore skips the replica upload, device_refresh
            # catches it up from the mirror re-seeded below
            if self._resolve_device_sync() == "deferred":
                self._device_stale = True
            else:
                # (the device tier's emit mirror rebuilds from the counts)
                self._upload_columns(panes, counts_np, restored)
            if self.emit_tier == "device":
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

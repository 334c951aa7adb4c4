"""Basic stream operators: map/filter/flatMap, keyBy, timestamps and
watermarks, the keyed running reduce, side outputs and sinks, all batched
(port of ``flink_tpu/operators/basic.py``).

The stateless operators and the sinks are host numpy, as in JAX.  The one
device step is :class:`KeyedReduceOperator`'s: per batch, a stable sort by
key slot, JAX's segmented inclusive scan (``ops/scatter.py``
``segment_running_fold``), a combine with each key's persisted accumulator,
one write per key and an un-sort, in torch ops on the operator's device (the
combine is the aggregate's, user code, so there is no hand-written kernel).
The batch is padded as JAX pads it, and the running values are JAX's bit
for bit.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from flink_tpu_torch import DeviceLike, resolve_device
from flink_tpu_torch.core import keygroups
from flink_tpu_torch.core.batch import (MAX_WATERMARK, RecordBatch,
                                        StreamElement, Watermark)
from flink_tpu_torch.core.functions import (AggregateFunction, RuntimeContext,
                                            canonical_tensor, torch_dtype,
                                            tree_leaves, tree_structure,
                                            tree_unflatten)
from flink_tpu_torch.core.watermarks import WatermarkGenerator
from flink_tpu_torch.operators.base import StreamOperator
from flink_tpu_torch.operators.window_agg import _PhaseTimer
from flink_tpu_torch.ops.scatter import segment_running_fold
from flink_tpu_torch.state.keyindex import (key_index_kind, make_key_index,
                                            restore_key_index)


def _key_index(keys: np.ndarray, snap=None):
    """The key index, as JAX's operators pick it (``make_key_index``): a
    fresh one for ``keys``, or restored from ``snap``.  Integer keys take
    the C keydict, other keys an ``ObjectKeyIndex``."""
    if snap is not None:
        return restore_key_index(snap["keys"],
                                 snap.get("key_index_kind", "KeyIndex"))
    keys = np.asarray(keys)
    return make_key_index(keys[0] if keys.ndim else keys)


class MapOperator(StreamOperator):
    """Vectorized map: ``fn(columns dict) -> columns dict`` (row-aligned)."""

    is_stateless = True

    def __init__(self, fn: Callable[[Dict[str, Any]], Dict[str, Any]],
                 name: str = "map"):
        self.fn = fn
        self.name = name

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        return [batch.with_columns(self.fn(dict(batch.columns)))]


class FilterOperator(StreamOperator):
    """Vectorized filter: ``fn(columns) -> bool mask [B]``."""

    is_stateless = True

    def __init__(self, fn: Callable[[Dict[str, Any]], np.ndarray],
                 name: str = "filter"):
        self.fn = fn
        self.name = name

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        mask = np.asarray(self.fn(dict(batch.columns)))
        if mask.all():
            return [batch]
        return [batch.select(mask)]


class FlatMapOperator(StreamOperator):
    """Vectorized flatMap: ``fn(columns) -> (new_columns, src_rows)``, where
    ``src_rows`` names the input row of each output row, so timestamps and
    keys follow their rows."""

    is_stateless = True

    def __init__(self, fn: Callable[[Dict[str, Any]], Any],
                 name: str = "flat-map"):
        self.fn = fn
        self.name = name

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        cols, src = self.fn(dict(batch.columns))
        src = np.asarray(src)
        meta = [None if a is None else np.asarray(a)[src]
                for a in (batch.timestamps, batch.key_ids, batch.key_groups)]
        return [RecordBatch(cols, *meta)]


class KeyByOperator(StreamOperator):
    """Attaches key-group routing (``KeyGroupStreamPartitioner``):
    ``key_group = murmur(hash(key)) % max_parallelism`` per record, the
    unit that routing and state sharding agree on.  Dense key slots stay
    with the stateful operator downstream."""

    is_stateless = True

    def __init__(self, key_column: str, max_parallelism: int = 128,
                 name: str = "key-by"):
        self.key_column = key_column
        self.max_parallelism = max_parallelism
        self.name = name

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        keys = np.asarray(batch.column(self.key_column))
        kg = keygroups.assign_to_key_group(keygroups.hash_keys(keys),
                                           self.max_parallelism)
        return [batch.with_keys(batch.key_ids, kg)]


class TimestampsAndWatermarksOperator(StreamOperator):
    """Extracts event timestamps and emits watermarks
    (``TimestampsAndWatermarksOperator.java``, batched: the generator sees
    each batch's timestamp column once)."""

    forwards_watermarks = False   # this operator owns event time downstream

    def __init__(self, generator: WatermarkGenerator,
                 timestamp_column: Optional[str] = None,
                 timestamp_fn: Optional[Callable[[Dict[str, Any]],
                                                 np.ndarray]] = None,
                 name: str = "timestamps-watermarks"):
        self.generator = generator
        self.timestamp_column = timestamp_column
        self.timestamp_fn = timestamp_fn
        self.name = name

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        if self.timestamp_fn is not None:
            ts = np.asarray(self.timestamp_fn(dict(batch.columns)), np.int64)
        elif self.timestamp_column is not None:
            ts = np.asarray(batch.column(self.timestamp_column), np.int64)
        else:
            ts = batch.timestamps
        out: List[StreamElement] = [batch.with_timestamps(ts)]
        wm = self.generator.on_batch(ts)
        if wm is not None:
            out.append(Watermark(wm))
        return out

    def process_watermark(self, watermark: Watermark) -> List[StreamElement]:
        # upstream watermarks are ignored (this operator owns event time),
        # except MAX_WATERMARK, the end of input, so bounded jobs flush
        if watermark.timestamp >= MAX_WATERMARK:
            return [Watermark(MAX_WATERMARK)]
        return []

    def snapshot_state(self) -> Dict[str, Any]:
        # the generator's max-seen timestamp survives restores
        return {"gen": dict(self.generator.__dict__)}

    def restore_state(self, snapshot: Dict[str, Any]) -> None:
        self.generator.__dict__.update(snapshot.get("gen", {}))


class KeyedReduceOperator(StreamOperator):
    """``keyBy().reduce(fn)``: emits each key's running fold for EVERY
    input record (``StreamGroupedReduceOperator`` semantics), batched:
    sort the batch by key slot, segmented inclusive scan, combine each row's
    in-batch prefix with the key's persisted accumulator, write the last
    row of each key, un-sort.  The accumulators live in ``[K, *leaf]``
    tensors on ``device`` (the card unless the CPU is asked for); ``K``
    doubles from ``max(1024, initial_key_capacity)`` as keys arrive.
    ``phase_ns`` times the host's share of each batch: ``probe`` (the key
    index, as JAX's ``make_key_index`` picks it),
    ``device_dispatch`` (padding, uploads and the step's launches) and
    ``emit`` (the running values' download and the output batch)."""

    def __init__(self, agg: AggregateFunction, key_column: str,
                 value_column: Optional[str] = None,
                 output_column: str = "result",
                 initial_key_capacity: int = 1 << 10,
                 name: str = "keyed-reduce", device: DeviceLike = None):
        self.agg = agg
        self.key_column = key_column
        self.value_column = value_column
        self.output_column = output_column
        self.name = name
        self.device = resolve_device(device)
        self.spec = agg.acc_spec()
        self._K = max(1 << 10, initial_key_capacity)
        self.key_index = None    # NativeKeyIndex or ObjectKeyIndex
        self._leaves = None
        self.phase_ns: Dict[str, int] = {}

    def _alloc(self, K: int):
        return tuple(
            torch.full((K,) + tuple(shape), np.asarray(init).item(),
                       dtype=torch_dtype(dtype), device=self.device)
            for init, shape, dtype in zip(self.spec.leaf_inits,
                                          self.spec.leaf_shapes,
                                          self.spec.leaf_dtypes))

    def _step(self, slot_ids: torch.Tensor, values):
        """One batch on the device: the running fold of every row, the
        persisted accumulators updated in place.  Returns the un-sorted
        running results (a tensor or dict of tensors)."""
        combine = self.agg.combine_leaves
        lifted = tuple(tree_leaves(self.agg.lift(values)))
        order, sids, is_end, prefix = segment_running_fold(slot_ids, lifted,
                                                           combine)
        K = self._leaves[0].shape[0]
        safe = torch.clamp(sids, max=K - 1).to(torch.int64)
        current = tuple(l[safe] for l in self._leaves)
        running = combine(current, prefix)
        keep = is_end & (sids < K)      # pad rows carry slot K: dropped
        idx = safe[keep]
        for l, r in zip(self._leaves, running):
            l[idx] = r[keep].to(l.dtype)
        inv = torch.argsort(order)
        return self.agg.get_result(self.spec.unflatten(
            tuple(r[inv] for r in running)))

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        if len(batch) == 0:
            return []
        keys = np.asarray(batch.column(self.key_column))
        if self.key_index is None:
            self.key_index = _key_index(keys)
        with _PhaseTimer(self.phase_ns, "probe"):
            slot_ids = self.key_index.lookup_or_insert(keys)
        if self._leaves is None:
            self._leaves = self._alloc(self._K)
        while self.key_index.num_keys > self._K:
            grown = self._alloc(self._K * 2)
            for g, l in zip(grown, self._leaves):
                g[:self._K] = l
            self._leaves = grown
            self._K *= 2
        values = (batch.column(self.value_column) if self.value_column
                  else dict(batch.columns))
        # JAX pads to a power of two (one compile per size); the pad rows
        # carry slot K and zero values, and the port pads alike
        B = len(batch)
        Bp = max(64, 1 << (B - 1).bit_length())

        def upload(a):
            a = np.asarray(a)
            padded = np.zeros((Bp,) + a.shape[1:], a.dtype)
            padded[:B] = a
            return canonical_tensor(torch.from_numpy(padded)).to(
                self.device)
        with _PhaseTimer(self.phase_ns, "device_dispatch"):
            ids = np.full(Bp, self._K, np.int32)
            ids[:B] = slot_ids
            dev_values = tree_unflatten(
                tree_structure(values),
                [upload(a) for a in tree_leaves(values)])
            out = self._step(torch.from_numpy(ids).to(self.device),
                             dev_values)
        with _PhaseTimer(self.phase_ns, "emit"):
            out = tree_unflatten(tree_structure(out),
                                 [r[:B].cpu().numpy()
                                  for r in tree_leaves(out)])
            cols = dict(batch.columns)
            if isinstance(out, dict):
                cols.update(out)
            else:
                cols[self.output_column] = out
            return [RecordBatch(cols, batch.timestamps, batch.key_ids,
                                batch.key_groups)]

    def snapshot_state(self) -> Dict[str, Any]:
        if self.key_index is None:
            return {"empty": True}
        n = self.key_index.num_keys
        return {"empty": False,
                "keys": self.key_index.snapshot(),
                "key_index_kind": key_index_kind(self.key_index),
                # a copy: on the CPU ``.cpu()`` would alias the live state
                "leaves": [l[:n].cpu().numpy().copy()
                           for l in self._leaves]}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        if snap.get("empty", True):
            return
        self.key_index = _key_index(None, snap)
        while self._K < self.key_index.num_keys:
            self._K *= 2
        self._leaves = self._alloc(self._K)
        for l, s in zip(self._leaves, snap["leaves"]):
            s = torch.from_numpy(np.array(s))    # a writable copy
            l[:s.shape[0]] = s.to(self.device, l.dtype)


class SideOutputOperator(StreamOperator):
    """Takes one side output's tag (``DataStream.getSideOutput``): unwraps
    the matching tagged batches and drops the main stream."""

    def __init__(self, tag: str, name: str = "side-output"):
        self.accepts_tag = tag
        self.name = name

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        return []   # main-stream data does not pass

    def process_tagged(self, batch: RecordBatch) -> List[StreamElement]:
        return [batch]


class SinkOperator(StreamOperator):
    """Terminal operator around a sink (``StreamSink``)."""

    def __init__(self, sink, name: str = "sink"):
        # transactional sinks declare clone_per_subtask: each parallel
        # instance needs its OWN epoch buffers and transaction identity
        if getattr(sink, "clone_per_subtask", False):
            sink = copy.deepcopy(sink)
            on_cloned = getattr(sink, "on_cloned", None)
            if on_cloned is not None:
                on_cloned()
        self.sink = sink
        self.name = name

    def open(self, ctx: RuntimeContext) -> None:
        super().open(ctx)
        if hasattr(self.sink, "open"):
            self.sink.open(ctx)

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        self.sink.write_batch(batch)
        return []

    def process_watermark(self, watermark: Watermark) -> List[StreamElement]:
        if hasattr(self.sink, "on_watermark"):
            self.sink.on_watermark(watermark.timestamp)
        return []

    def on_latency_marker(self, marker) -> None:
        """Source-to-sink latency sample (``LatencyStats`` at the sink),
        read through the clock seam (``utils/clock.py``), so a chaos skew
        covers latency tracking; a skew-negative sample clamps to 0.  The
        newest samples stay in ``latencies_ms`` (past 1024, the oldest 512
        go)."""
        from flink_tpu_torch.utils import clock

        self.latencies_ms = getattr(self, "latencies_ms", [])
        self.latencies_ms.append(max(
            0.0, (clock.now_ms_f() / 1000.0 - marker.marked_time) * 1000.0))
        if len(self.latencies_ms) > 1024:
            del self.latencies_ms[:512]

    def end_input(self) -> List[StreamElement]:
        # transactional sinks commit their last epoch at the end of input
        if hasattr(self.sink, "end_input"):
            self.sink.end_input()
        elif hasattr(self.sink, "flush"):
            self.sink.flush()
        return []

    def snapshot_state(self) -> Dict[str, Any]:
        if hasattr(self.sink, "snapshot_state"):
            return self.sink.snapshot_state()
        return {}

    def restore_state(self, snapshot: Dict[str, Any]) -> None:
        if snapshot and hasattr(self.sink, "restore_state"):
            self.sink.restore_state(snapshot)

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        if hasattr(self.sink, "notify_checkpoint_complete"):
            self.sink.notify_checkpoint_complete(checkpoint_id)

    def close(self) -> None:
        if hasattr(self.sink, "close"):
            self.sink.close()


class ExtremumByOperator(StreamOperator):
    """``KeyedStream.minBy/maxBy``: per key, the FULL ROW of the extreme
    element so far (ties keep the first arrival, ``minBy(field,
    first=true)``); each batch emits the current extreme of every touched
    key with the triggering record's timestamp.  Host numpy, as in JAX;
    NaN rows never win and are ignored."""

    def __init__(self, key_column: str, value_column: str, is_min: bool,
                 name: str = "extremum-by"):
        self.key_column = key_column
        self.value_column = value_column
        self.is_min = is_min
        self.name = name
        self.key_index = None    # NativeKeyIndex or ObjectKeyIndex
        self._vals = np.zeros(0, np.float64)   # slot -> extreme value
        self._rows = np.zeros(0, object)       # slot -> extreme row dict

    def _ensure(self, n: int) -> None:
        if n > self._vals.size:
            cap = max(n, max(16, self._vals.size * 2))
            sentinel = np.inf if self.is_min else -np.inf
            nv = np.full(cap, sentinel, np.float64)
            nv[:self._vals.size] = self._vals
            nr = np.empty(cap, object)
            nr[:self._rows.size] = self._rows
            self._vals, self._rows = nv, nr

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        if len(batch) == 0:
            return []
        # a stored NaN would poison every later strict comparison
        vals_all = np.asarray(batch.column(self.value_column), np.float64)
        finite = ~np.isnan(vals_all)
        if not finite.all():
            batch = batch.select(finite)
            if len(batch) == 0:
                return []
        n = len(batch)
        keys = np.asarray(batch.column(self.key_column))
        vals = np.asarray(batch.column(self.value_column), np.float64)
        ts = (np.asarray(batch.timestamps)
              if batch.timestamps is not None else None)
        if self.key_index is None:
            self.key_index = _key_index(keys)
        slots = self.key_index.lookup_or_insert(keys).astype(np.int64)
        self._ensure(self.key_index.num_keys)
        _uniq, inv = np.unique(slots, return_inverse=True)
        # the batch's extreme per key: lexsort by (key, value, arrival),
        # the first row of each key wins
        sort_vals = vals if self.is_min else -vals
        order = np.lexsort((np.arange(n), sort_vals, inv))
        first = np.ones(n, bool)
        first[1:] = inv[order][1:] != inv[order][:-1]
        winners = order[first]
        rows = batch.take(winners).to_rows()
        out_rows: List[Dict[str, Any]] = []
        out_ts: List[int] = []
        better = (lambda a, b: a < b) if self.is_min else (lambda a, b: a > b)
        for row, w in zip(rows, winners.tolist()):
            slot = int(slots[w])
            v = float(vals[w])
            if self._rows[slot] is None or better(v, self._vals[slot]):
                self._vals[slot] = v
                self._rows[slot] = row
            out_rows.append(self._rows[slot])
            # the TRIGGERING record's timestamp: the stored extreme may be
            # arbitrarily behind the watermark
            out_ts.append(int(ts[w]) if ts is not None else 0)
        return [RecordBatch.from_rows(
            out_rows, timestamps=out_ts if ts is not None else None)]

    def snapshot_state(self) -> Dict[str, Any]:
        if self.key_index is None:
            return {"empty": True}
        n = self.key_index.num_keys
        return {"empty": False,
                "keys": self.key_index.snapshot(),
                "key_index_kind": key_index_kind(self.key_index),
                "state.vals": self._vals[:n].copy(),
                "state.rows": self._rows[:n].copy()}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        if snap.get("empty", True):
            return
        self.key_index = _key_index(None, snap)
        n = self.key_index.num_keys
        self._ensure(n)
        self._vals[:n] = np.asarray(snap["state.vals"])
        self._rows[:n] = np.asarray(snap["state.rows"], object)

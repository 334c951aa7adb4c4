"""Sliding count windows: ``countWindow(size, slide)`` (port of
``flink_tpu/operators/count_window.py``, which is host numpy in JAX too: the
operator has no device work, and the port keeps it on the host, with the
port's int64 key index and its own ``tree_leaves``).

The reference composes this as GlobalWindows + ``CountTrigger.of(slide)``
+ ``CountEvictor.of(size)``
(``WindowedStream.countWindow(size, slide)`` in
``flink-streaming-java/.../api/datastream/WindowedStream.java``): every
``slide`` elements per key, emit the aggregate of that key's LAST
``size`` elements.  This operator implements it directly, with a dense
state shape in place of a trigger and an evictor:

- per key, a **ring of the last ``size`` values** (dense ``[K, size]``,
  write position = arrival_count %% size — the ring IS the CountEvictor),
- an arrival counter and a fired-multiple register per key (the
  CountTrigger's ``ReducingState<Long>`` analog),
- vectorized batch fold: per-key ranks within the batch come from one
  stable argsort; the ring scatter is one fancy assignment (duplicate
  (key, pos) writes resolve last-wins = arrival order).

Mini-batch semantics (the repo's count-trigger convention, matching the
SQL bundle operators): fires are evaluated once per micro-batch — a key
crossing several ``slide`` multiples inside one batch fires ONCE with
its latest ring, not once per multiple.  Aggregates must declare numpy
twins (every built-in does); ring combine order is irrelevant because
the combine is commutative by contract.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from flink_tpu_torch.core.batch import RecordBatch, StreamElement, Watermark
from flink_tpu_torch.core.functions import (SCATTER_UFUNCS, AggregateFunction,
                                            RuntimeContext, tree_leaves)
from flink_tpu_torch.operators.base import StreamOperator
from flink_tpu_torch.operators.basic import _key_index
from flink_tpu_torch.state.keyindex import NativeKeyIndex


class CountSlideWindowOperator(StreamOperator):
    """``key_by(k).count_window(size, slide).aggregate(agg)``."""

    def __init__(self, agg: AggregateFunction, key_column: str,
                 value_column: str, size: int, slide: int,
                 output_column: str = "result",
                 initial_key_capacity: int = 1 << 10,
                 name: str = "count-slide-window"):
        if size <= 0 or slide <= 0:
            raise ValueError("count_window size and slide must be positive")
        if not agg.supports_host_emit():
            raise ValueError("count_window(size, slide) needs an aggregate "
                             "with numpy twins (all built-ins qualify)")
        self.agg = agg
        self.kinds = agg.scatter_kind_leaves()
        self.spec = agg.acc_spec()
        self.key_column = key_column
        self.value_column = value_column
        self.size = int(size)
        self.slide = int(slide)
        self.output_column = output_column
        self.name = name
        self._K = max(64, initial_key_capacity)
        self.key_index: Optional[NativeKeyIndex] = None
        self._ring: Optional[np.ndarray] = None      # f64 [K, size]
        self._count: Optional[np.ndarray] = None     # i64 [K]
        self._fired: Optional[np.ndarray] = None     # i64 [K] slide multiples

    def open(self, ctx: RuntimeContext) -> None:
        pass

    def _ensure(self, n_keys: int) -> None:
        while self._K < n_keys:
            self._K <<= 1
        if self._ring is None:
            self._ring = np.zeros((self._K, self.size), np.float64)
            self._count = np.zeros(self._K, np.int64)
            self._fired = np.zeros(self._K, np.int64)
        elif self._ring.shape[0] < self._K:
            old = self._ring.shape[0]
            ring = np.zeros((self._K, self.size), np.float64)
            ring[:old] = self._ring
            self._ring = ring
            self._count = np.concatenate(
                [self._count, np.zeros(self._K - old, np.int64)])
            self._fired = np.concatenate(
                [self._fired, np.zeros(self._K - old, np.int64)])

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        if len(batch) == 0:
            return []
        keys = np.asarray(batch.column(self.key_column))
        vals = np.asarray(batch.column(self.value_column), np.float64)
        if self.key_index is None:
            self.key_index = _key_index(keys)
        slots = np.asarray(self.key_index.lookup_or_insert(keys), np.int64)
        self._ensure(self.key_index.num_keys)
        n = len(slots)
        # per-key rank within the batch (arrival order): stable sort groups
        order = np.argsort(slots, kind="stable")
        ss = slots[order]
        starts = np.r_[True, ss[1:] != ss[:-1]]
        gstart = np.maximum.accumulate(np.where(starts, np.arange(n), 0))
        rank_sorted = np.arange(n) - gstart
        rank = np.empty(n, np.int64)
        rank[order] = rank_sorted
        pos = (self._count[slots] + rank) % self.size
        # fancy assignment in ARRIVAL order: duplicate (slot, pos) pairs
        # (a key receiving > size rows in one batch laps its ring) resolve
        # last-write-wins = the newest element, the CountEvictor semantics
        self._ring[slots, pos] = vals
        self._count[: self._K] += np.bincount(
            slots, minlength=self._K)[: self._K]
        # fire keys that crossed >= 1 slide multiple (mini-batch semantics)
        nk = self.key_index.num_keys
        mult = self._count[:nk] // self.slide
        fire = np.flatnonzero(mult > self._fired[:nk])
        if fire.size == 0:
            return []
        self._fired[:nk][fire] = mult[fire]
        return self._emit(fire)

    def _emit(self, fire: np.ndarray) -> List[StreamElement]:
        rows = self._ring[fire]                      # [m, size]
        valid = (np.arange(self.size)[None, :]
                 < np.minimum(self._count[fire], self.size)[:, None])
        lifted = self.agg.host_lift(rows.reshape(-1))
        leaves = []
        for leaf, kind in zip(tree_leaves(lifted), self.kinds):
            leaf = np.asarray(leaf).reshape(fire.size, self.size)
            ident = self._identity(kind, leaf.dtype)
            masked = np.where(valid, leaf, ident)
            leaves.append(SCATTER_UFUNCS[kind].reduce(masked, axis=1))
        result = self.agg.host_get_result(self.spec.unflatten(leaves))
        raw_keys = np.asarray(self.key_index.reverse_keys())[fire]
        cols: Dict[str, Any] = {self.key_column: raw_keys}
        if isinstance(result, dict):
            cols.update(result)
        else:
            cols[self.output_column] = result
        return [RecordBatch(cols)]

    @staticmethod
    def _identity(kind: str, dtype) -> Any:
        if kind == "add":
            return np.zeros((), dtype)
        if np.issubdtype(dtype, np.integer):
            info = np.iinfo(dtype)
            return dtype.type(info.max if kind == "min" else info.min)
        return np.float64(np.inf if kind == "min" else -np.inf)

    def process_watermark(self, watermark: Watermark) -> List[StreamElement]:
        return []                       # counts, not time, drive fires

    def end_input(self) -> List[StreamElement]:
        # trailing partial slide emits nothing — reference drops partial
        # countWindows at end of input
        return []

    # ------------------------------------------------------------ snapshots
    def snapshot_state(self) -> Dict[str, Any]:
        snap: Dict[str, Any] = {}
        if self.key_index is not None:
            snap["key_index"] = self.key_index.snapshot()
            snap["key_index_kind"] = "KeyIndex"
            n = self.key_index.num_keys
            snap["ring"] = self._ring[:n].copy()
            snap["count"] = self._count[:n].copy()
            snap["fired"] = self._fired[:n].copy()
        return snap

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self._ring = None
        self.key_index = None
        if "key_index" not in snap:
            return
        self.key_index = _key_index(None, {
            "keys": snap["key_index"],
            "key_index_kind": snap["key_index_kind"]})
        n = self.key_index.num_keys
        self._ensure(max(n, 1))
        self._ring[:n] = snap["ring"]
        self._count[:n] = snap["count"]
        self._fired[:n] = snap["fired"]

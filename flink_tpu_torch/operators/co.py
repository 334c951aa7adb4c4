"""Two-input operators: connected streams + broadcast state pattern (port of
``flink_tpu/operators/co.py``; host numpy, as JAX's).

Analogs of the reference's ``CoStreamMap``/``CoProcessOperator``
(``TwoInputStreamOperator`` family) and the broadcast state pattern
(``CoBroadcastWithKeyedOperator`` + ``api/common/state/BroadcastState``):
input 0 is the main (possibly keyed) stream, input 1 the second/broadcast
side.  Batched: each side's batches arrive whole; the broadcast side is
replicated to every parallel subtask by the BROADCAST edge partitioning, so
each subtask holds an identical copy of the broadcast state — exactly the
reference's invariant.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from flink_tpu_torch.core.batch import RecordBatch, StreamElement, Watermark
from flink_tpu_torch.core.functions import RuntimeContext
from flink_tpu_torch.operators.base import StreamOperator


class CoMapOperator(StreamOperator):
    """``connect().map(f1, f2)``: two row-wise transforms into one output
    stream (``CoStreamMap`` analog). Functions take/return column dicts."""

    is_two_input = True

    def __init__(self, fn1: Callable, fn2: Callable, name: str = "co-map"):
        self.fns = (fn1, fn2)
        self.name = name

    def process_batch2(self, batch: RecordBatch,
                       input_index: int) -> List[StreamElement]:
        cols = self.fns[input_index](dict(batch.columns))
        return [_with_ts(cols, batch)]

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        return self.process_batch2(batch, 0)


def _with_ts(cols: Dict[str, Any], src_batch: RecordBatch) -> RecordBatch:
    """Rebuild a batch, keeping event-time timestamps when the fn preserved
    the row count (a size-changing fn cannot inherit per-row times)."""
    out = RecordBatch({k: np.asarray(v) for k, v in cols.items()})
    if src_batch.timestamps is not None and len(out) == len(src_batch):
        out = out.with_timestamps(np.asarray(src_batch.timestamps))
    return out


class CoFlatMapOperator(StreamOperator):
    """``connect().flat_map(f1, f2)``: each fn returns a columns dict (any
    row count) or None."""

    is_two_input = True

    def __init__(self, fn1: Callable, fn2: Callable, name: str = "co-flat-map"):
        self.fns = (fn1, fn2)
        self.name = name

    def process_batch2(self, batch: RecordBatch,
                       input_index: int) -> List[StreamElement]:
        cols = self.fns[input_index](dict(batch.columns))
        if cols is None:
            return []
        return [_with_ts(cols, batch)]

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        return self.process_batch2(batch, 0)


class CoProcessFunction:
    """User function for ``connect().process()`` — batched
    ``CoProcessFunction`` analog. Override either side; return a columns
    dict (or None) to emit."""

    def open(self, ctx: RuntimeContext) -> None:
        pass

    def process_batch1(self, cols: Dict[str, Any], ctx) -> Optional[Dict[str, Any]]:
        return None

    def process_batch2(self, cols: Dict[str, Any], ctx) -> Optional[Dict[str, Any]]:
        return None

    def on_watermark(self, timestamp: int, ctx) -> Optional[Dict[str, Any]]:
        return None


class CoProcessOperator(StreamOperator):
    is_two_input = True

    def __init__(self, fn: CoProcessFunction, name: str = "co-process"):
        self.fn = fn
        self.name = name

    def open(self, ctx: RuntimeContext) -> None:
        super().open(ctx)
        self.fn.open(ctx)

    def process_batch2(self, batch: RecordBatch,
                       input_index: int) -> List[StreamElement]:
        handler = (self.fn.process_batch1 if input_index == 0
                   else self.fn.process_batch2)
        out = handler(dict(batch.columns), self)
        if out is None:
            return []
        return [_with_ts(out, batch)]

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        return self.process_batch2(batch, 0)

    def process_watermark(self, watermark: Watermark) -> List[StreamElement]:
        out = self.fn.on_watermark(watermark.timestamp, self)
        if out is None:
            return []
        return [RecordBatch({k: np.asarray(v) for k, v in out.items()})]


class BroadcastProcessFunction:
    """Batched ``KeyedBroadcastProcessFunction`` analog.

    ``process_batch(cols, broadcast_state, ctx)`` handles main-stream
    batches; ``process_broadcast_batch(cols, broadcast_state, ctx)`` updates
    the broadcast state (a plain dict replicated on every subtask).
    """

    def open(self, ctx: RuntimeContext) -> None:
        pass

    def process_batch(self, cols: Dict[str, Any],
                      broadcast_state: Dict[Any, Any],
                      ctx) -> Optional[Dict[str, Any]]:
        return None

    def process_broadcast_batch(self, cols: Dict[str, Any],
                                broadcast_state: Dict[Any, Any],
                                ctx) -> None:
        pass


class BroadcastConnectOperator(StreamOperator):
    """Main stream (input 0) + broadcast rule stream (input 1) with
    checkpointed broadcast state (``BroadcastState`` analog: each subtask
    keeps an identical copy because the edge replicates every rule batch)."""

    is_two_input = True

    def __init__(self, fn: BroadcastProcessFunction,
                 name: str = "broadcast-connect"):
        self.fn = fn
        self.name = name
        self.broadcast_state: Dict[Any, Any] = {}

    def open(self, ctx: RuntimeContext) -> None:
        super().open(ctx)
        self.fn.open(ctx)

    def process_batch2(self, batch: RecordBatch,
                       input_index: int) -> List[StreamElement]:
        if input_index == 1:
            self.fn.process_broadcast_batch(dict(batch.columns),
                                            self.broadcast_state, self)
            return []
        out = self.fn.process_batch(dict(batch.columns),
                                    self.broadcast_state, self)
        if out is None:
            return []
        return [_with_ts(out, batch)]

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        return self.process_batch2(batch, 0)

    def snapshot_state(self) -> Dict[str, Any]:
        return {"broadcast_state": dict(self.broadcast_state)}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self.broadcast_state = dict(snap.get("broadcast_state", {}))

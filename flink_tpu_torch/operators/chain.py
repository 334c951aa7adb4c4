"""Operator chain: fused execution of consecutive same-parallelism operators (port of ``flink_tpu/operators/chain.py``).

Analog of ``OperatorChain.java:88`` — chained outputs are direct calls, no
re-batching or serialization between chain members.  Control elements
(watermarks, processing time, end-of-input) are threaded through every member
in order, with each member's emissions delivered to the next *before* the
control element itself — the same ordering the reference's
``ChainingOutput`` + in-band control flow guarantees.
"""

from __future__ import annotations

from typing import Any, Dict, List

from flink_tpu_torch.core.batch import RecordBatch, StreamElement, Watermark
from flink_tpu_torch.core.functions import RuntimeContext
from flink_tpu_torch.operators.base import StreamOperator


class ChainedOperator(StreamOperator):
    def __init__(self, operators: List[StreamOperator], name: str = "chain"):
        self.operators = operators
        self.name = name
        self.is_stateless = all(op.is_stateless for op in operators)
        self.forwards_watermarks = all(op.forwards_watermarks for op in operators)

    def open(self, ctx: RuntimeContext) -> None:
        super().open(ctx)
        for op in self.operators:
            op.open(ctx)

    def _feed(self, start: int, elements: List[StreamElement]) -> List[StreamElement]:
        """Push elements through chain members [start:]; returns chain output."""
        for op in self.operators[start:]:
            nxt: List[StreamElement] = []
            for el in elements:
                if isinstance(el, RecordBatch):
                    nxt.extend(op.process_batch(el))
                elif isinstance(el, Watermark):
                    nxt.extend(op.process_watermark(el))
                    if op.forwards_watermarks:
                        nxt.append(el)
                else:
                    nxt.append(el)
            elements = nxt
        return elements

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        return self._feed(0, [batch])

    def process_watermark(self, watermark: Watermark) -> List[StreamElement]:
        # Deliver to member i, push its fires through members i+1.., then move
        # the watermark itself to member i+1 (unless member i owns event time
        # and blocks it).  The executor appends the watermark downstream after
        # this returns, gated on self.forwards_watermarks.
        out: List[StreamElement] = []
        for i, op in enumerate(self.operators):
            out.extend(self._feed(i + 1, op.process_watermark(watermark)))
            if not op.forwards_watermarks:
                break
        return out

    def on_processing_time(self, timestamp_ms: int) -> List[StreamElement]:
        out: List[StreamElement] = []
        for i, op in enumerate(self.operators):
            out.extend(self._feed(i + 1, op.on_processing_time(timestamp_ms)))
        return out

    def end_input(self) -> List[StreamElement]:
        out: List[StreamElement] = []
        for i, op in enumerate(self.operators):
            out.extend(self._feed(i + 1, op.end_input()))
        return out

    def flush_pipeline(self) -> List[StreamElement]:
        """Driver idle hook: barrier every chained operator's pipeline."""
        out: List[StreamElement] = []
        for i, op in enumerate(self.operators):
            out.extend(self._feed(i + 1, op.flush_pipeline()))
        return out

    def on_latency_marker(self, marker):
        """Markers flow around user functions; a recording member (sink)
        consumes them, otherwise the marker continues downstream."""
        handled = False
        for op in self.operators:
            hook = getattr(op, "on_latency_marker", None)
            if hook is not None:
                hook(marker)
                handled = True
        return [] if handled else [marker]

    def prepare_snapshot_pre_barrier(self) -> List[StreamElement]:
        # getattr: operators are duck-typed to the StreamOperator protocol;
        # this hook is newer than some user/test operators, so absence
        # means "nothing to drain" (same guard as the task runtimes)
        out: List[StreamElement] = []
        for i, op in enumerate(self.operators):
            prep = getattr(op, "prepare_snapshot_pre_barrier", None)
            if prep is not None:
                out.extend(self._feed(i + 1, prep()))
        return out

    def snapshot_state(self) -> Dict[str, Any]:
        return {f"op{i}": op.snapshot_state() for i, op in enumerate(self.operators)}

    def restore_state(self, snapshot: Dict[str, Any]) -> None:
        if not snapshot:
            return
        if not any(f"op{i}" in snapshot for i in range(len(self.operators))):
            # flat KEYED snapshot (e.g. a bootstrapped savepoint from the
            # state processor API): hand it to the chain's single
            # keyed-stateful member (the one owning a keyed backend/index)
            keyed = [op for op in self.operators
                     if hasattr(op, "backend") or hasattr(op, "key_index")]
            if len(keyed) == 1:
                keyed[0].restore_state(snapshot)
                return
            if snapshot:
                raise ValueError(
                    f"chain {self.name!r}: flat snapshot cannot be attributed "
                    f"({len(keyed)} keyed-stateful members); write the "
                    f"savepoint with per-member op0/op1/... structure")
        for i, op in enumerate(self.operators):
            if f"op{i}" in snapshot:
                op.restore_state(snapshot[f"op{i}"])

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        # the reference's OperatorChain.notifyCheckpointComplete notifies
        # EVERY member: 2PC sinks commit, queryable views tag the
        # consistency point — a chained member must not miss it
        for op in self.operators:
            hook = getattr(op, "notify_checkpoint_complete", None)
            if hook is not None:
                hook(checkpoint_id)

    def close(self) -> None:
        for op in self.operators:
            op.close()

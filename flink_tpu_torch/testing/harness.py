"""Operator test harness (port of ``flink_tpu/testing/harness.py``).

Analog of the reference's workhorse test infrastructure
(``KeyedOneInputStreamOperatorTestHarness.java`` +
``TestProcessingTimeService.java``, SURVEY §4.2): run one operator with manual
control of elements, watermarks and processing time, collecting everything it
emits — no cluster, no executor.  ``WindowOperatorTest.java`` (3,364 LoC) is
the usage model: push elements + watermarks, assert (value, timestamp) pairs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from flink_tpu_torch.core.batch import RecordBatch, StreamElement, Watermark
from flink_tpu_torch.core.functions import RuntimeContext
from flink_tpu_torch.operators.base import StreamOperator


class TestProcessingTimeService:
    """Manually-advanced processing-time clock (``TestProcessingTimeService.java``)."""

    def __init__(self, start_ms: int = 0):
        self.now = start_ms

    def advance_to(self, t_ms: int) -> int:
        self.now = max(self.now, t_ms)
        return self.now


class KeyedOneInputOperatorHarness:
    """Push batches / watermarks / time into one operator; collect its output."""

    def __init__(self, operator: StreamOperator, ctx: Optional[RuntimeContext] = None):
        self.op = operator
        self.time_service = TestProcessingTimeService()
        # operators read wall clock via _now_ms; patch to the test clock
        if hasattr(operator, "_now_ms"):
            operator._now_ms = lambda: self.time_service.now  # type: ignore
        operator.open(ctx or RuntimeContext())
        self.output: List[StreamElement] = []

    # ---- input ----
    def process_batch(self, batch: RecordBatch) -> None:
        self.output.extend(self.op.process_batch(batch))

    def process_elements(self, rows: Sequence[Dict[str, Any]],
                         timestamps: Optional[Sequence[int]] = None) -> None:
        self.process_batch(RecordBatch.from_rows(list(rows), list(timestamps) if timestamps is not None else None))

    def process_watermark(self, ts: int) -> None:
        self.output.extend(self.op.process_watermark(Watermark(ts)))
        self.output.append(Watermark(ts))

    def set_processing_time(self, t_ms: int) -> None:
        self.time_service.advance_to(t_ms)
        self.output.extend(self.op.on_processing_time(t_ms))

    def end_input(self) -> None:
        self.output.extend(self.op.end_input())

    # ---- output ----
    def extract_output_batches(self) -> List[RecordBatch]:
        return [e for e in self.output if isinstance(e, RecordBatch)]

    def extract_output_rows(self) -> List[Dict[str, Any]]:
        rows: List[Dict[str, Any]] = []
        for b in self.extract_output_batches():
            rws = b.to_rows()
            if b.timestamps is not None:
                for r, t in zip(rws, np.asarray(b.timestamps)):
                    r["__ts__"] = int(t)
            rows.extend(rws)
        return rows

    def extract_watermarks(self) -> List[int]:
        return [e.timestamp for e in self.output if isinstance(e, Watermark)]

    def clear_output(self) -> None:
        self.output = []

    # ---- checkpointing ----
    def snapshot(self) -> Dict[str, Any]:
        return self.op.snapshot_state()

    @staticmethod
    def restored(operator: StreamOperator, snapshot: Dict[str, Any],
                 ctx: Optional[RuntimeContext] = None) -> "KeyedOneInputOperatorHarness":
        h = KeyedOneInputOperatorHarness(operator, ctx)
        operator.restore_state(snapshot)
        return h


def sorted_rows(rows: List[Dict[str, Any]], by: Tuple[str, ...]) -> List[Dict[str, Any]]:
    return sorted(rows, key=lambda r: tuple(r[k] for k in by))

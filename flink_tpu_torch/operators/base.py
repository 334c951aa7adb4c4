"""Stream operator contract, batched (minimal port of ``flink_tpu/operators/base.py``).

An operator consumes a ``RecordBatch`` and returns the elements it emits;
the executor owns ordering and forwards watermarks after the operator saw them.
"""

from __future__ import annotations

from typing import Any, Dict, List

from flink_tpu_torch.core.batch import RecordBatch, StreamElement, Watermark
from flink_tpu_torch.core.functions import RuntimeContext


class StreamOperator:
    """Base operator: lifecycle, element processing, snapshots."""

    name: str = "operator"

    def open(self, ctx: RuntimeContext) -> None:
        self.ctx = ctx

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        raise NotImplementedError

    def process_watermark(self, watermark: Watermark) -> List[StreamElement]:
        """Called on watermark advance; returns fired elements."""
        return []

    def end_input(self) -> List[StreamElement]:
        """Bounded-input flush (``BoundedOneInput.endInput`` analog)."""
        return []

    def prepare_snapshot_pre_barrier(self) -> List[StreamElement]:
        """Called before the snapshot: elements to forward ahead of it."""
        return []

    def snapshot_state(self) -> Dict[str, Any]:
        """Host-side state dict of numpy arrays."""
        return {}

    def restore_state(self, snapshot: Dict[str, Any]) -> None:
        pass

    def close(self) -> None:
        pass

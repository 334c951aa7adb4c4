"""Stream operator contract, batched (minimal port of ``flink_tpu/operators/base.py``).

An operator consumes a ``RecordBatch`` and returns the elements it emits;
the executor owns ordering and forwards watermarks after the operator saw them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from flink_tpu_torch.core.batch import RecordBatch, StreamElement, Watermark
from flink_tpu_torch.core.functions import RuntimeContext


class StreamOperator:
    """Base operator: lifecycle, element processing, snapshots."""

    name: str = "operator"
    #: operators that only transform rows (no state, no time)
    is_stateless: bool = False
    #: False for operators that OWN event time (timestamps and watermarks):
    #: upstream watermarks are not forwarded past them
    forwards_watermarks: bool = True
    #: the side-output tag whose ``TaggedBatch`` elements this operator
    #: takes through :meth:`process_tagged` (None: it drops them)
    accepts_tag: Optional[str] = None

    def open(self, ctx: RuntimeContext) -> None:
        self.ctx = ctx

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        raise NotImplementedError

    def process_tagged(self, batch: RecordBatch) -> List[StreamElement]:
        """A side-output batch of the tag in :attr:`accepts_tag`."""
        return []

    def process_watermark(self, watermark: Watermark) -> List[StreamElement]:
        """Called on watermark advance; returns fired elements."""
        return []

    def end_input(self) -> List[StreamElement]:
        """Bounded-input flush (``BoundedOneInput.endInput`` analog)."""
        return []

    def flush_pipeline(self) -> List[StreamElement]:
        """Pipeline barrier: operators that pipeline or stage their hot
        path complete it here; a task loop calls it at idle points, so
        pipelined work never waits for the next batch.  Default: no-op."""
        return []

    def prepare_snapshot_pre_barrier(self) -> List[StreamElement]:
        """Called before the snapshot: elements to forward ahead of it."""
        return []

    def snapshot_state(self) -> Dict[str, Any]:
        """Host-side state dict of numpy arrays."""
        return {}

    def restore_state(self, snapshot: Dict[str, Any]) -> None:
        pass

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        """The checkpoint is durably stored (``CheckpointListener``):
        two-phase-commit side effects may publish now."""

    def close(self) -> None:
        pass

"""Stream operator contract, batched (port of ``flink_tpu/operators/base.py``).

An operator consumes a ``RecordBatch`` and returns the elements it emits;
the executor owns ordering and forwards watermarks after the operator saw them.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, List, Optional

from flink_tpu_torch.core.batch import RecordBatch, StreamElement, Watermark
from flink_tpu_torch.core.functions import RuntimeContext

#: checkpoint id of the snapshot being taken, visible to any operator inside
#: the snapshot call tree (a runtime sets it around ``snapshot_state()``;
#: 2PC sinks stage their transactions under it).  A ContextVar, so
#: concurrent subtask threads stay isolated.
_CURRENT_CHECKPOINT_ID: contextvars.ContextVar[Optional[int]] = \
    contextvars.ContextVar("flink_tpu_torch_current_checkpoint_id",
                           default=None)

#: True while the snapshot being taken may ship delta increments instead of
#: full state (incremental checkpointing on, and the cut neither a
#: savepoint nor a final snapshot).  Operators with delta tracking (the
#: changelog-backed ``KeyedProcessOperator``) read it in ``snapshot_state``.
_SNAPSHOT_INCREMENTAL: contextvars.ContextVar[bool] = \
    contextvars.ContextVar("flink_tpu_torch_snapshot_incremental",
                           default=False)


def current_checkpoint_id() -> Optional[int]:
    """Checkpoint id of the in-progress snapshot, or None outside one."""
    return _CURRENT_CHECKPOINT_ID.get()


def snapshot_is_incremental() -> bool:
    """May the in-progress snapshot ship a delta increment?  False outside
    a snapshot, for savepoints and for final snapshots."""
    return _SNAPSHOT_INCREMENTAL.get()


@contextlib.contextmanager
def snapshot_scope(checkpoint_id: Optional[int], incremental: bool = False):
    """Runtimes wrap an operator's ``snapshot_state()`` in this scope, so
    sinks can tie staged transactions to the checkpoint id and
    delta-tracking operators know whether increments are allowed."""
    tok = _CURRENT_CHECKPOINT_ID.set(checkpoint_id)
    tok2 = _SNAPSHOT_INCREMENTAL.set(incremental)
    try:
        yield
    finally:
        _SNAPSHOT_INCREMENTAL.reset(tok2)
        _CURRENT_CHECKPOINT_ID.reset(tok)


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
    #: two-input operators receive batches through :meth:`process_batch2`
    is_two_input: bool = False

    def open(self, ctx: RuntimeContext) -> None:
        self.ctx = ctx

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        raise NotImplementedError

    def process_batch2(self, batch: RecordBatch,
                       input_index: int) -> List[StreamElement]:
        """Two-input path (``processElement1/2``); called only when
        :attr:`is_two_input` is True."""
        raise NotImplementedError

    def process_tagged(self, batch: RecordBatch) -> List[StreamElement]:
        """A side-output batch of the tag in :attr:`accepts_tag`."""
        return []

    def process_watermark(self, watermark: Watermark) -> List[StreamElement]:
        """Called on watermark advance; returns fired elements."""
        return []

    def on_processing_time(self, timestamp_ms: int) -> List[StreamElement]:
        """Processing-time tick (``onProcessingTime``): the runtime reads
        the clock seam between source rounds and hands every operator the
        time; returns what fired."""
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

    def metric_group(self):
        """The operator's metric group (``ctx.metrics``), or None before
        :meth:`open` or outside a runtime that registers metrics."""
        return getattr(getattr(self, "ctx", None), "metrics", None)

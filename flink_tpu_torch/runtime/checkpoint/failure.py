"""Checkpoint failure policy: tolerate-then-failover.

Analog of ``runtime/checkpoint/CheckpointFailureManager.java``: declined,
timed-out and storage-failed checkpoints increment a *continuous* failure
counter that resets on every successful checkpoint; once the counter
exceeds ``tolerable_failed_checkpoints``
(``execution.checkpointing.tolerable-failed-checkpoints``) the job fails
over through its restart strategy.  Pre-trigger declines ("busy", sources
already finished) are NOT counted, matching the reference's ignored
``CHECKPOINT_COORDINATOR_*`` reasons — only checkpoints that were actually
in flight count against the budget.

The port's copy of ``flink_tpu/runtime/checkpoint/failure.py`` (host Python, as JAX's).
"""

from __future__ import annotations

from typing import Optional

from flink_tpu_torch.metrics.core import Counter


class CheckpointFailureReason:
    """Counted failure reasons (``CheckpointFailureReason.java`` subset)."""

    DECLINED = "declined"            # a task declined (snapshot error)
    TIMEOUT = "expired"              # alignment/acks not done in time
    STORAGE = "storage"              # completed-checkpoint store failed


class CheckpointFailureManager:
    """Continuous-failure accounting + the failover decision.

    Thread-safety is the CALLER's: both runtimes invoke this under their
    coordinator lock, exactly like the reference calls it from the
    CheckpointCoordinator's timer/IO thread with coordinator-wide
    ordering."""

    UNLIMITED = -1

    def __init__(self, tolerable_failed_checkpoints: int = 0):
        if tolerable_failed_checkpoints < self.UNLIMITED:
            raise ValueError("tolerable_failed_checkpoints must be >= -1 "
                             f"(got {tolerable_failed_checkpoints})")
        self.tolerable = tolerable_failed_checkpoints
        self._continuous = 0
        #: lifetime counters (numberOfFailedCheckpoints /
        #: numberOfCompletedCheckpoints metric analogs)
        self.failed_counter = Counter()
        self.completed_counter = Counter()
        self.last_failure_reason: Optional[str] = None
        self.last_failure_checkpoint_id: Optional[int] = None

    # -- events ------------------------------------------------------------
    def on_checkpoint_success(self, checkpoint_id: int) -> None:
        self._continuous = 0
        self.completed_counter.inc()

    def on_checkpoint_failure(self, reason: str,
                              checkpoint_id: Optional[int] = None) -> bool:
        """Record one in-flight checkpoint failure; True = the tolerable
        budget is exhausted and the job must fail over."""
        self._continuous += 1
        self.failed_counter.inc()
        self.last_failure_reason = reason
        self.last_failure_checkpoint_id = checkpoint_id
        if self.tolerable == self.UNLIMITED:
            return False
        return self._continuous > self.tolerable

    def on_job_restart(self) -> None:
        """A failover wipes in-flight checkpoint attempts: the continuous
        window restarts with the new execution (lifetime counters keep
        accumulating for observability)."""
        self._continuous = 0

    # -- introspection -----------------------------------------------------
    @property
    def continuous_failures(self) -> int:
        return self._continuous

    def num_failed(self) -> int:
        return self.failed_counter.get_count()

    def num_completed(self) -> int:
        return self.completed_counter.get_count()

    def status(self) -> dict:
        """REST-facing summary (job_status() embeds this)."""
        return {
            "tolerable_failed_checkpoints": self.tolerable,
            "continuous_failed_checkpoints": self._continuous,
            "failed_checkpoints": self.num_failed(),
            "last_failure_reason": self.last_failure_reason,
            "last_failure_checkpoint_id": self.last_failure_checkpoint_id,
        }

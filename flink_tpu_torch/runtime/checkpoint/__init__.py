"""Checkpointing (port of ``flink_tpu/runtime/checkpoint``): storage,
the failure manager (exported here, as JAX's package does), and the
``delta``, ``incremental``, ``local`` and ``objectstore`` modules."""

from flink_tpu_torch.runtime.checkpoint.failure import (
    CheckpointFailureManager,
    CheckpointFailureReason,
)
from flink_tpu_torch.runtime.checkpoint.storage import (
    CorruptCheckpointError,
    FileCheckpointStorage,
    InMemoryCheckpointStorage,
    RetryingCheckpointStorage,
    read_savepoint,
    write_savepoint,
)

__all__ = [
    "CheckpointFailureManager",
    "CheckpointFailureReason",
    "CorruptCheckpointError",
    "FileCheckpointStorage",
    "InMemoryCheckpointStorage",
    "RetryingCheckpointStorage",
    "read_savepoint",
    "write_savepoint",
]

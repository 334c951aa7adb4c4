"""Checkpoint storage (the storage module of ``flink_tpu/runtime/checkpoint``;
the failure manager, local recovery, object stores and incremental
checkpoints come with ROADMAP Queue A item 9)."""

from flink_tpu_torch.runtime.checkpoint.storage import (
    CorruptCheckpointError,
    FileCheckpointStorage,
    InMemoryCheckpointStorage,
    RetryingCheckpointStorage,
    read_savepoint,
    write_savepoint,
)

__all__ = [
    "CorruptCheckpointError",
    "FileCheckpointStorage",
    "InMemoryCheckpointStorage",
    "RetryingCheckpointStorage",
    "read_savepoint",
    "write_savepoint",
]

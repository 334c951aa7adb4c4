"""The State Processor API (port of ``flink_tpu/state_processor``)."""

from flink_tpu_torch.state_processor.savepoint import Savepoint, SavepointWriter

__all__ = ["Savepoint", "SavepointWriter"]

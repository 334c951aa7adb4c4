"""The DataSet API (port of ``flink_tpu/dataset``)."""

from flink_tpu_torch.dataset.api import DataSet, ExecutionEnvironment

__all__ = ["DataSet", "ExecutionEnvironment"]

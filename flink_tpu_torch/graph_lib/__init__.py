"""The graph library (port of ``flink_tpu/graph_lib``): :class:`Graph`."""

from flink_tpu_torch.graph_lib.graph import Graph

__all__ = ["Graph"]

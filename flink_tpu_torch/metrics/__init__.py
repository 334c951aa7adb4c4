"""Metrics system: types, hierarchical groups and the registry (port of
``flink_tpu/metrics``; the reporters come with the observability slice).

Reference analogs: ``flink-metrics-core`` (types) and ``runtime/metrics/``
(registry + scoped groups).
"""

from flink_tpu_torch.metrics.core import (Counter, Gauge, Histogram, Meter,
                                          Metric, SettableGauge)
from flink_tpu_torch.metrics.groups import (BUSY_TIME, CURRENT_WATERMARK,
                                            NUM_LATE_RECORDS_DROPPED,
                                            NUM_RECORDS_IN, NUM_RECORDS_OUT,
                                            MetricGroup, MetricRegistry,
                                            OperatorIOMetrics,
                                            task_metric_group)

__all__ = [
    "Counter", "Gauge", "SettableGauge", "Meter", "Histogram", "Metric",
    "MetricGroup", "MetricRegistry", "OperatorIOMetrics", "task_metric_group",
    "NUM_RECORDS_IN", "NUM_RECORDS_OUT", "NUM_LATE_RECORDS_DROPPED",
    "CURRENT_WATERMARK", "BUSY_TIME",
]

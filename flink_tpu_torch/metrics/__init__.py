"""Metrics system: types, hierarchical groups, registry, reporters (port of
``flink_tpu/metrics``, host Python as JAX's).

Reference analogs: ``flink-metrics-core`` (types + reporter SPI),
``runtime/metrics/`` (registry + scoped groups), ``flink-metrics-prometheus``
(exposition reporter).
"""

from flink_tpu_torch.metrics.core import (Counter, Gauge, Histogram, Meter,
                                          Metric, SettableGauge)
from flink_tpu_torch.metrics.groups import (BUSY_TIME, CURRENT_WATERMARK,
                                            NUM_LATE_RECORDS_DROPPED,
                                            NUM_RECORDS_IN, NUM_RECORDS_OUT,
                                            MetricGroup, MetricRegistry,
                                            OperatorIOMetrics,
                                            task_metric_group)
from flink_tpu_torch.metrics.reporters import (GraphiteReporter,
                                               InfluxDBReporter,
                                               LoggingReporter,
                                               MetricReporter,
                                               PrometheusReporter,
                                               StatsDReporter)

__all__ = [
    "Counter", "Gauge", "SettableGauge", "Meter", "Histogram", "Metric",
    "MetricGroup", "MetricRegistry", "OperatorIOMetrics", "task_metric_group",
    "MetricReporter", "LoggingReporter", "PrometheusReporter",
    "StatsDReporter", "GraphiteReporter", "InfluxDBReporter",
    "NUM_RECORDS_IN", "NUM_RECORDS_OUT", "NUM_LATE_RECORDS_DROPPED",
    "CURRENT_WATERMARK", "BUSY_TIME",
]

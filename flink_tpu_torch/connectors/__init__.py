"""Connectors (the port's copy of ``flink_tpu/connectors``): sources,
sinks, the file source and its two-phase-commit ``FileSink``, the split
enumerators, the Kafka wire connector (``kafka``, ``kafka_v2``), the
partitioned log and its HTTP log service (``log_service``), and the
Postgres, Kinesis, Cassandra, Elasticsearch and RabbitMQ connectors.
"""

from flink_tpu_torch.connectors.sinks import (CollectSink, FunctionSink,
                                              PrintSink, Sink)
from flink_tpu_torch.connectors.sources import (
    CollectionSource,
    GeneratorSource,
    IteratorSource,
    SocketTextSource,
    Source,
    SourceSplit,
)
from flink_tpu_torch.connectors.postgres import (
    PostgresSink,
    PostgresSource,
    PostgresWireClient,
    PostgresWireServer,
)

__all__ = [
    "CollectSink", "FunctionSink", "PrintSink", "Sink",
    "CollectionSource", "GeneratorSource", "IteratorSource",
    "SocketTextSource", "Source", "SourceSplit",
    "PostgresSink", "PostgresSource", "PostgresWireClient",
    "PostgresWireServer",
]

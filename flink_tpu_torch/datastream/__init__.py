from flink_tpu_torch.datastream.api import (
    DataStream,
    DataStreamSink,
    KeyedStream,
    StreamExecutionEnvironment,
    WindowedStream,
)

__all__ = [
    "DataStream",
    "DataStreamSink",
    "KeyedStream",
    "StreamExecutionEnvironment",
    "WindowedStream",
]

from flink_tpu_torch.cep.operator import CEP, PatternStream
from flink_tpu_torch.core.batch import OutputTag
from flink_tpu_torch.datastream.api import (
    ConnectedStreams,
    DataStream,
    DataStreamSink,
    IntervalJoinBuilder,
    IterativeStream,
    JoinBuilder,
    KeyedStream,
    StreamExecutionEnvironment,
    WindowedStream,
)
from flink_tpu_torch.operators.async_io import AsyncFunction
from flink_tpu_torch.operators.co import (BroadcastProcessFunction,
                                          CoProcessFunction)

__all__ = [
    "AsyncFunction",
    "BroadcastProcessFunction",
    "CEP",
    "CoProcessFunction",
    "ConnectedStreams",
    "DataStream",
    "DataStreamSink",
    "IntervalJoinBuilder",
    "IterativeStream",
    "JoinBuilder",
    "KeyedStream",
    "OutputTag",
    "PatternStream",
    "StreamExecutionEnvironment",
    "WindowedStream",
]

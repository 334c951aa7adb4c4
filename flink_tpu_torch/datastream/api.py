"""DataStream API — the fluent program-construction surface (port of
``flink_tpu/datastream/api.py``).

Analog of ``flink-streaming-java/.../api/datastream/`` +
``StreamExecutionEnvironment.java:1873``: each call appends a
``Transformation`` node; ``env.execute()`` translates the DAG through
``StreamGraph`` (chaining) into an ``ExecutionPlan`` and runs it on
``LocalExecutor``.  Records are columnar batches, so user functions are
vectorized (columns-dict in/out) — see ``operators/basic.py``.

The environment's ``device`` (None: the card) goes to every device operator
it builds, through :func:`flink_tpu_torch.resolve_device` when the job's
operators are built: a job on the CPU asks for it (``device="cpu"``), and
nothing falls back on its own.  Host operators (map, filter, keyBy,
timestamps, sessions, sinks) need no device.  The routes whose modules come
with later slices raise ``NotImplementedError`` and name their item of
``ROADMAP.md`` Queue A: the MiniCluster (8.4); two-input, async and
iteration operators, the host evicting lane, the window and interval joins
and the environment's mesh (8.2); late side outputs (8.1).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from flink_tpu_torch import DeviceLike, resolve_device
from flink_tpu_torch.config.config_option import Configuration
from flink_tpu_torch.connectors.sinks import CollectSink, PrintSink, Sink
from flink_tpu_torch.connectors.sources import (CollectionSource,
                                                SocketTextSource, Source)
from flink_tpu_torch.core.functions import (AggregateFunction, AvgAggregator,
                                            CountAggregator, LambdaReduce,
                                            MaxAggregator, MinAggregator,
                                            ReduceFunction, SumAggregator)
from flink_tpu_torch.core.watermarks import (BoundedOutOfOrdernessWatermarks,
                                             WatermarkGenerator)
from flink_tpu_torch.graph.stream_graph import StreamGraph
from flink_tpu_torch.graph.transformations import Partitioning, Transformation
from flink_tpu_torch.operators.basic import (FilterOperator, FlatMapOperator,
                                             KeyByOperator,
                                             KeyedReduceOperator, MapOperator,
                                             SinkOperator,
                                             TimestampsAndWatermarksOperator)
from flink_tpu_torch.operators.window_agg import WindowAggOperator
from flink_tpu_torch.runtime.executor import JobExecutionResult, LocalExecutor
from flink_tpu_torch.windowing.assigners import WindowAssigner
from flink_tpu_torch.windowing.triggers import Trigger

__all__ = ["StreamExecutionEnvironment", "DataStream", "KeyedStream",
           "WindowedStream", "DataStreamSink", "SlidingCountWindowedStream",
           "LATER"]

#: the routes of the JAX API whose modules later slices bring, by the item
#: of ROADMAP.md Queue A that clears each
LATER = {
    "cluster": "the MiniCluster comes with the cluster runtime (8.4)",
    "mesh": "the environment's mesh comes with the DataStream routing to "
            "the mesh operators (8.2)",
    "two_input": "two-input operators (connect, broadcast state) come with "
                 "the host operators (8.2)",
    "async": "async I/O comes with the host operators (8.2)",
    "iteration": "streaming iterations come with the host operators (8.2)",
    "joins": "the window and interval joins' DataStream routes come with "
             "8.2",
    "host_evicting": "the host evicting lane (apply over raw elements) "
                     "comes with the host operators (8.2)",
    "late_output": "late side outputs come with the rest of the local job "
                   "path (8.1)",
}


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"not in this slice of flink_tpu_torch: "
                               f"{LATER[what]}")


class StreamExecutionEnvironment:
    """``StreamExecutionEnvironment`` analog: source factories + execute().
    ``device`` is where its device operators run (None: the card)."""

    def __init__(self, config: Optional[Configuration] = None,
                 parallelism: int = 1, max_parallelism: int = 128,
                 mesh=None, device: DeviceLike = None):
        if mesh is not None:
            raise _later("mesh")
        self.config = config or Configuration()
        self.parallelism = parallelism
        self.max_parallelism = max_parallelism
        self.device = device
        self._sinks: List[Transformation] = []
        self.checkpoint_interval_ms = 0
        self.checkpoint_storage = None
        self.mesh = None

    def set_mesh(self, mesh=None, n_devices: Optional[int] = None
                 ) -> "StreamExecutionEnvironment":
        raise _later("mesh")

    @staticmethod
    def get_execution_environment(
            config: Optional[Configuration] = None,
            device: DeviceLike = None) -> "StreamExecutionEnvironment":
        return StreamExecutionEnvironment(config, device=device)

    def operator_device(self) -> torch.device:
        """The device a device operator of this job runs on (resolved when
        the job's operators are built; raises without a card unless the
        CPU was asked for)."""
        return resolve_device(self.device)

    def set_parallelism(self, p: int) -> "StreamExecutionEnvironment":
        self.parallelism = p
        return self

    def set_max_parallelism(self, p: int) -> "StreamExecutionEnvironment":
        self.max_parallelism = p
        return self

    def enable_checkpointing(self, interval_ms: int,
                             storage=None) -> "StreamExecutionEnvironment":
        """Periodic checkpoints of the local job into ``storage``: any
        object with ``store(checkpoint_id, snapshot)``."""
        self.checkpoint_interval_ms = interval_ms
        self.checkpoint_storage = storage
        return self

    # ------------------------------------------------------------- sources
    def from_source(self, source: Source, name: str = "source") -> "DataStream":
        t = Transformation(name=name, operator_factory=None, is_source=True,
                           source=source, chainable=True,
                           parallelism=self.parallelism,
                           max_parallelism=self.max_parallelism)
        # source vertices need a pass-through operator for the chain head
        t.operator_factory = _identity_operator_factory(name)
        return DataStream(self, t)

    def from_collection(self, rows: Optional[Sequence[Mapping[str, Any]]] = None,
                        columns: Optional[Mapping[str, Any]] = None,
                        timestamp_column: Optional[str] = None,
                        batch_size: int = 4096,
                        name: str = "collection-source") -> "DataStream":
        return self.from_source(
            CollectionSource(rows, columns, timestamp_column, batch_size), name)

    def socket_text_stream(self, host: str, port: int,
                           batch_size: int = 4096) -> "DataStream":
        return self.from_source(SocketTextSource(host, port, batch_size),
                                f"socket:{host}:{port}")

    def generate_sequence(self, start: int, end: int,
                          batch_size: int = 4096) -> "DataStream":
        return self.from_collection(
            columns={"value": np.arange(start, end + 1, dtype=np.int64)},
            batch_size=batch_size, name="sequence-source")

    # ------------------------------------------------------------- execute
    def _register_sink(self, t: Transformation) -> None:
        self._sinks.append(t)

    def get_stream_graph(self, job_name: str = "job") -> StreamGraph:
        if not self._sinks:
            raise ValueError("no sinks registered — nothing to execute")
        return StreamGraph.from_sinks(self._sinks, self.parallelism,
                                      self.max_parallelism, job_name)

    def execute(self, job_name: str = "job",
                restore: Optional[Dict[str, Any]] = None,
                max_records: Optional[int] = None,
                max_wall_ms: Optional[int] = None,
                drain: bool = True) -> JobExecutionResult:
        plan = self.get_stream_graph(job_name).to_plan()
        executor = LocalExecutor(
            checkpoint_interval_ms=self.checkpoint_interval_ms,
            checkpoint_storage=self.checkpoint_storage,
            max_records=max_records, max_wall_ms=max_wall_ms,
            config=self.config)
        # publish BEFORE the blocking run so another thread can cancel()
        self._last_executor = executor
        return executor.execute(plan, restore=restore, drain=drain)

    def execute_cluster(self, *args, **kwargs):
        """The MiniCluster route of JAX's API (real parallelism, one thread
        per subtask); it comes with the cluster runtime."""
        raise _later("cluster")


def _identity_operator_factory(name: str):
    from flink_tpu_torch.operators.base import StreamOperator

    class _Identity(StreamOperator):
        is_stateless = True

        def process_batch(self, batch):
            return [batch]

    def make():
        op = _Identity()
        op.name = name
        return op

    return make


class DataStream:
    """Fluent stream handle appending transformations (``DataStream.java``)."""

    def __init__(self, env: StreamExecutionEnvironment, transformation: Transformation):
        self.env = env
        self.transformation = transformation

    def _then(self, name: str, factory, partitioning: str = Partitioning.FORWARD,
              key_column: Optional[str] = None, chainable: bool = True) -> Transformation:
        return Transformation(name=name, operator_factory=factory,
                              inputs=[self.transformation],
                              partitioning=partitioning,
                              key_column=key_column, chainable=chainable,
                              parallelism=self.env.parallelism,
                              max_parallelism=self.env.max_parallelism)

    def map(self, fn: Callable[[Dict[str, Any]], Dict[str, Any]],
            name: str = "map") -> "DataStream":
        return DataStream(self.env, self._then(name, lambda: MapOperator(fn, name)))

    def filter(self, fn: Callable[[Dict[str, Any]], np.ndarray],
               name: str = "filter") -> "DataStream":
        return DataStream(self.env, self._then(name, lambda: FilterOperator(fn, name)))

    def flat_map(self, fn, name: str = "flat-map") -> "DataStream":
        return DataStream(self.env, self._then(name, lambda: FlatMapOperator(fn, name)))

    def assign_timestamps_and_watermarks(
            self, generator_or_ooo: Union[WatermarkGenerator, int],
            timestamp_column: Optional[str] = None,
            timestamp_fn=None, name: str = "timestamps") -> "DataStream":
        if isinstance(generator_or_ooo, WatermarkGenerator):
            gen_proto = generator_or_ooo
        else:
            gen_proto = BoundedOutOfOrdernessWatermarks(int(generator_or_ooo))

        def factory():
            return TimestampsAndWatermarksOperator(
                copy.deepcopy(gen_proto), timestamp_column, timestamp_fn, name)

        return DataStream(self.env, self._then(name, factory))

    def key_by(self, key_column: str) -> "KeyedStream":
        t = self._then(f"key-by:{key_column}",
                       lambda: KeyByOperator(key_column,
                                             self.env.max_parallelism),
                       partitioning=Partitioning.HASH, key_column=key_column)
        return KeyedStream(self.env, t, key_column)

    def union(self, *others: "DataStream") -> "DataStream":
        t = Transformation(
            name="union", operator_factory=_identity_operator_factory("union"),
            inputs=[self.transformation] + [o.transformation for o in others],
            parallelism=self.env.parallelism,
            max_parallelism=self.env.max_parallelism)
        return DataStream(self.env, t)

    def _repartition(self, name: str, partitioning: str) -> "DataStream":
        t = self._then(name, _identity_operator_factory(name),
                       partitioning=partitioning, chainable=False)
        return DataStream(self.env, t)

    def rebalance(self) -> "DataStream":
        return self._repartition("rebalance", Partitioning.REBALANCE)

    def broadcast(self) -> "DataStream":
        return self._repartition("broadcast", Partitioning.BROADCAST)

    def shuffle(self) -> "DataStream":
        """Uniform-random redistribution (``ShufflePartitioner`` analog)."""
        return self._repartition("shuffle", Partitioning.SHUFFLE)

    def rescale(self) -> "DataStream":
        """Round-robin within the producer's local consumer group
        (``RescalePartitioner`` analog)."""
        return self._repartition("rescale", Partitioning.RESCALE)

    def global_(self) -> "DataStream":
        """Route everything to subtask 0 (``GlobalPartitioner`` analog)."""
        return self._repartition("global", Partitioning.GLOBAL)

    def iterate(self, max_wait_ms: int = 200):
        raise _later("iteration")

    # ------------------------------------------------- two-input operations
    def connect(self, other: "DataStream"):
        raise _later("two_input")

    def connect_broadcast(self, rules: "DataStream", fn,
                          name: str = "broadcast-connect"):
        raise _later("two_input")

    def join(self, other: "DataStream"):
        raise _later("joins")

    def co_group(self, other: "DataStream"):
        raise _later("joins")

    def get_side_output(self, tag) -> "DataStream":
        """Side-output stream of an upstream process function
        (``getSideOutput`` analog). ``tag``: OutputTag or name."""
        from flink_tpu_torch.core.batch import OutputTag
        from flink_tpu_torch.operators.basic import SideOutputOperator

        name = tag.name if isinstance(tag, OutputTag) else str(tag)
        t = self._then(f"side-output:{name}",
                       lambda: SideOutputOperator(name), chainable=False)
        return DataStream(self.env, t)

    def async_wait(self, fn, capacity: int = 16, timeout_ms: int = 60_000,
                   ordered: bool = True, name: str = "async-wait"):
        raise _later("async")

    # -------------------------------------------------------------- sinks
    def add_sink(self, sink: Sink, name: str = "sink") -> "DataStreamSink":
        t = self._then(name, lambda: SinkOperator(sink, name))
        t.is_sink = True
        self.env._register_sink(t)
        return DataStreamSink(self.env, t, sink)

    sink_to = add_sink

    def print(self, prefix: str = "") -> "DataStreamSink":
        return self.add_sink(PrintSink(prefix), name="print")

    def collect(self) -> CollectSink:
        """Attach a CollectSink and return it (executeAndCollect helper)."""
        sink = CollectSink()
        self.add_sink(sink, name="collect")
        return sink

    def execute_and_collect(self, job_name: str = "collect-job") -> List[Dict[str, Any]]:
        sink = self.collect()
        self.env.execute(job_name)
        return sink.rows()


class DataStreamSink:
    def __init__(self, env: StreamExecutionEnvironment, transformation: Transformation,
                 sink: Sink):
        self.env = env
        self.transformation = transformation
        self.sink = sink

    def name(self, name: str) -> "DataStreamSink":
        self.transformation.name = name
        return self

    def uid(self, uid: str) -> "DataStreamSink":
        self.transformation.uid = uid
        return self


class KeyedStream(DataStream):
    """``KeyedStream.java`` analog: windowing + keyed aggregations."""

    def __init__(self, env: StreamExecutionEnvironment, transformation: Transformation,
                 key_column: str):
        super().__init__(env, transformation)
        self.key_column = key_column

    def interval_join(self, other: "KeyedStream"):
        raise _later("joins")

    def count_window(self, size: int, slide: Optional[int] = None):
        """``countWindow(size[, slide])`` analog.  Without ``slide``:
        GlobalWindows + purging CountTrigger — fires every ``size``
        elements per key with that batch's aggregate, then clears.  With
        ``slide``: every ``slide`` elements per key, emit the aggregate
        of the key's last ``size`` elements (the reference's CountTrigger
        + CountEvictor composition, implemented as a per-key value ring —
        ``operators/count_window.py``; mini-batch fire semantics)."""
        if slide is not None:
            return SlidingCountWindowedStream(self, int(size), int(slide))
        from flink_tpu_torch.windowing.assigners import GlobalWindows
        from flink_tpu_torch.windowing.triggers import CountTrigger

        assigner = GlobalWindows.create()
        assigner.is_event_time = False  # counts, not timestamps, drive fires
        return self.window(assigner).trigger(CountTrigger.of(size,
                                                             purge=True))

    def window(self, assigner: WindowAssigner) -> "WindowedStream":
        return WindowedStream(self, assigner)

    def process(self, fn, name: str = "keyed-process") -> "DataStream":
        """Run a ``KeyedProcessFunction`` (keyed state + timers) on this
        stream (``KeyedStream.process`` analog).  The keyed backend follows
        ``state.backend`` in the environment config (heap / changelog)."""
        from flink_tpu_torch.operators.process import KeyedProcessOperator
        from flink_tpu_torch.state import make_keyed_backend
        key_col = self.key_column
        cfg = self.env.config
        maxp = self.env.max_parallelism
        return DataStream(self.env, self._then(
            name, lambda: KeyedProcessOperator(
                fn, key_col, name,
                backend=make_keyed_backend(cfg, max_parallelism=maxp))))

    def reduce(self, fn: Union[ReduceFunction, Callable], identity_value=None,
               value_column: Optional[str] = None,
               output_column: str = "result") -> "DataStream":
        agg = fn if isinstance(fn, ReduceFunction) else LambdaReduce(fn, identity_value)
        key_col = self.key_column
        env = self.env

        def factory():
            return KeyedReduceOperator(agg, key_col, value_column,
                                       output_column,
                                       device=env.operator_device())

        return DataStream(self.env, self._then("keyed-reduce", factory))

    def sum(self, value_column: str, output_column: Optional[str] = None,
            dtype=None) -> "DataStream":
        agg = SumAggregator(dtype or torch.float64)
        return self.reduce(agg, value_column=value_column,
                           output_column=output_column or value_column)

    def min(self, value_column: str, output_column: Optional[str] = None,
            dtype=None) -> "DataStream":
        agg = MinAggregator(dtype or torch.float64)
        return self.reduce(agg, value_column=value_column,
                           output_column=output_column or value_column)

    def max(self, value_column: str, output_column: Optional[str] = None,
            dtype=None) -> "DataStream":
        agg = MaxAggregator(dtype or torch.float64)
        return self.reduce(agg, value_column=value_column,
                           output_column=output_column or value_column)

    def min_by(self, value_column: str, name: str = "min-by") -> "DataStream":
        """Running FULL ROW of the minimum element per key
        (``minBy(field)`` analog; ties keep the first arrival)."""
        from flink_tpu_torch.operators.basic import ExtremumByOperator
        kc = self.key_column
        t = self._then(name, lambda: ExtremumByOperator(
            kc, value_column, is_min=True, name=name), chainable=False)
        return DataStream(self.env, t)

    def max_by(self, value_column: str, name: str = "max-by") -> "DataStream":
        """Running FULL ROW of the maximum element per key (``maxBy``)."""
        from flink_tpu_torch.operators.basic import ExtremumByOperator
        kc = self.key_column
        t = self._then(name, lambda: ExtremumByOperator(
            kc, value_column, is_min=False, name=name), chainable=False)
        return DataStream(self.env, t)


class SlidingCountWindowedStream:
    """``count_window(size, slide)``: terminal aggregate ops over the
    per-key last-``size`` ring (``WindowedStream.countWindow(size, slide)``
    analog; no time semantics, so only aggregate-family terminals)."""

    def __init__(self, keyed: "KeyedStream", size: int, slide: int):
        self.keyed = keyed
        self.size = size
        self.slide = slide

    def aggregate(self, agg: AggregateFunction,
                  value_column: Optional[str] = None,
                  output_column: str = "result",
                  name: str = "count-slide-window") -> "DataStream":
        from flink_tpu_torch.operators.count_window import \
            CountSlideWindowOperator

        if value_column is None:
            raise ValueError("count_window(size, slide).aggregate needs "
                             "value_column")
        # validate EAGERLY (the factory is deferred to execute time):
        # the ring combine needs the aggregate's numpy twins
        if self.size <= 0 or self.slide <= 0:
            raise ValueError("count_window size and slide must be positive")
        if not agg.supports_host_emit():
            raise ValueError(
                "count_window(size, slide) needs an aggregate with numpy "
                "twins and declared combine kinds (all built-ins qualify; "
                "a bare lambda reduce does not — use sum/min/max or an "
                "AggregateFunction with host_lift/host_get_result/"
                "scatter_kinds)")
        keyed, size, slide = self.keyed, self.size, self.slide

        def factory():
            return CountSlideWindowOperator(
                agg, key_column=keyed.key_column, value_column=value_column,
                size=size, slide=slide, output_column=output_column,
                name=name)

        return DataStream(keyed.env, keyed._then(name, factory))

    def reduce(self, fn: Union[ReduceFunction, Callable],
               identity_value=None, value_column: Optional[str] = None,
               output_column: str = "result") -> "DataStream":
        agg = fn if isinstance(fn, ReduceFunction) \
            else LambdaReduce(fn, identity_value)
        return self.aggregate(agg, value_column=value_column,
                              output_column=output_column)

    def sum(self, value_column: str,
            output_column: Optional[str] = None) -> "DataStream":
        return self.aggregate(SumAggregator(np.float64),
                              value_column=value_column,
                              output_column=output_column or value_column)

    def min(self, value_column: str,
            output_column: Optional[str] = None) -> "DataStream":
        return self.aggregate(MinAggregator(np.float64),
                              value_column=value_column,
                              output_column=output_column or value_column)

    def max(self, value_column: str,
            output_column: Optional[str] = None) -> "DataStream":
        return self.aggregate(MaxAggregator(np.float64),
                              value_column=value_column,
                              output_column=output_column or value_column)


class WindowedStream:
    """``WindowedStream.java`` analog (``reduce:162``, ``aggregate:283``)."""

    def __init__(self, keyed: KeyedStream, assigner: WindowAssigner):
        self.keyed = keyed
        self.assigner = assigner
        self._trigger: Optional[Trigger] = None
        self._allowed_lateness = 0
        self._evictor = None

    def trigger(self, trigger: Trigger) -> "WindowedStream":
        self._trigger = trigger
        return self

    def allowed_lateness(self, ms: int) -> "WindowedStream":
        self._allowed_lateness = ms
        return self

    def side_output_late_data(self, tag) -> "WindowedStream":
        raise _later("late_output")

    def evictor(self, evictor) -> "WindowedStream":
        """Window path with eviction (``evictor(...)`` analog): ``aggregate``/
        ``sum``/``count``/... with a Count/Time evictor run the device lane
        (``operators/evicting_device.py``)."""
        self._evictor = evictor
        return self

    def apply(self, fn, name: str = "window-apply") -> DataStream:
        raise _later("host_evicting")

    def aggregate(self, agg: AggregateFunction,
                  value_column: Optional[str] = None,
                  value_selector=None,
                  output_column: str = "result",
                  name: str = "window-agg",
                  emit_tier: Optional[str] = None,
                  paging=None,
                  pipeline_depth: int = 0,
                  native_shards: int = 0,
                  device_probe: str = "auto",
                  queryable: Optional[str] = None,
                  superbatch: int = 1) -> DataStream:
        """``paging``: a :class:`flink_tpu_torch.state.paging.PagingConfig`
        caps the operator's resident key capacity (cold keys page out to
        the spill tier).  ``emit_tier`` overrides the operator's tier pick
        ("host"/"device").  ``pipeline_depth`` > 0 runs the operator's hot
        stage as a bounded software pipeline; ``native_shards`` partitions
        the C host pass (0 = auto); ``device_probe`` gates the
        device-resident key probe ("auto" calibrates); ``superbatch``
        stages N micro-batches into one pass (0 = calibrated, 1 = off) —
        all bit-identical to the serial defaults, as in JAX.
        ``queryable`` raises in the operator (the serving slice)."""
        keyed, assigner = self.keyed, self.assigner
        env = keyed.env
        trigger, lateness = self._trigger, self._allowed_lateness
        ev = self._evictor
        if (paging is not None or emit_tier is not None) and (
                ev is not None or not hasattr(assigner, "pane_of")):
            raise ValueError("paging/emit_tier apply to the (unsharded) "
                             "pane-ring window operator — not evictors, "
                             "session windows or mesh-sharded state")
        if queryable is not None and (ev is not None
                                      or not hasattr(assigner, "pane_of")):
            raise ValueError("queryable= is served by the pane-ring window "
                             "operator — not evictors or session windows")
        if ev is not None:
            from flink_tpu_torch.operators.evicting_device import (
                DeviceEvictingWindowOperator, device_evictor_supported)
            if not device_evictor_supported(ev, agg):
                raise ValueError(
                    "evictor()+aggregate() runs on the device lane for "
                    "CountEvictor/TimeEvictor with built-in aggregates; "
                    "for other evictors use .apply(fn) (raw-element host "
                    "path)")
            if not hasattr(assigner, "pane_of"):
                raise ValueError(
                    "evictors require a pane-based window assigner "
                    "(tumbling/sliding); session windows do not support "
                    "evictors")
            if trigger is not None:
                raise ValueError("custom triggers / side outputs are not "
                                 "supported with evictors")
            if value_column is None:
                if isinstance(agg, CountAggregator):
                    # count() needs no value column; the buffer still needs
                    # SOME column — the key column is always present
                    value_column = keyed.key_column
                else:
                    raise ValueError(
                        "evictor()+aggregate() needs value_column")
            evictor_proto, evictor_vc = ev, value_column

            def factory():
                return DeviceEvictingWindowOperator(
                    assigner, copy.deepcopy(evictor_proto), agg,
                    key_column=keyed.key_column, value_column=evictor_vc,
                    output_column=output_column,
                    allowed_lateness_ms=lateness, name=name,
                    device=env.operator_device())

            return DataStream(env, keyed._then(name, factory))

        from flink_tpu_torch.windowing.assigners import SessionGap
        if isinstance(assigner, SessionGap):
            if trigger is not None:
                raise ValueError(
                    "custom triggers are not supported on session windows "
                    "(sessions fire when the gap closes); remove .trigger()")
            from flink_tpu_torch.operators.session_window import \
                SessionWindowOperator

            def factory():
                return SessionWindowOperator(
                    assigner, agg, key_column=keyed.key_column,
                    value_column=value_column, value_selector=value_selector,
                    allowed_lateness_ms=lateness,
                    output_column=output_column, name=name)
        else:
            def factory():
                kwargs = dict(
                    assigner=assigner, agg=agg, key_column=keyed.key_column,
                    value_column=value_column, value_selector=value_selector,
                    allowed_lateness_ms=lateness, trigger=trigger,
                    output_column=output_column, name=name)
                if emit_tier is not None:
                    kwargs["emit_tier"] = emit_tier
                return WindowAggOperator(paging=paging,
                                         pipeline_depth=pipeline_depth,
                                         native_shards=native_shards,
                                         device_probe=device_probe,
                                         queryable=queryable,
                                         superbatch=superbatch,
                                         device=env.operator_device(),
                                         **kwargs)

        return DataStream(env, keyed._then(name, factory))

    def reduce(self, fn: Union[ReduceFunction, Callable], identity_value=None,
               value_column: Optional[str] = None,
               output_column: str = "result") -> DataStream:
        agg = fn if isinstance(fn, ReduceFunction) else LambdaReduce(fn, identity_value)
        return self.aggregate(agg, value_column=value_column,
                              output_column=output_column, name="window-reduce")

    def sum(self, value_column: str, output_column: Optional[str] = None,
            dtype=None) -> DataStream:
        return self.aggregate(SumAggregator(dtype or torch.float64),
                              value_column=value_column,
                              output_column=output_column or value_column,
                              name="window-sum")

    def min(self, value_column: str, output_column: Optional[str] = None,
            dtype=None) -> DataStream:
        return self.aggregate(MinAggregator(dtype or torch.float64),
                              value_column=value_column,
                              output_column=output_column or value_column,
                              name="window-min")

    def max(self, value_column: str, output_column: Optional[str] = None,
            dtype=None) -> DataStream:
        return self.aggregate(MaxAggregator(dtype or torch.float64),
                              value_column=value_column,
                              output_column=output_column or value_column,
                              name="window-max")

    def count(self, output_column: str = "count") -> DataStream:
        def ones(cols):
            n = len(np.asarray(next(iter(cols.values()))))
            return np.ones(n, np.int32)

        return self.aggregate(CountAggregator(), value_column=None,
                              value_selector=ones,
                              output_column=output_column, name="window-count")

    def avg(self, value_column: str, output_column: Optional[str] = None,
            dtype=None) -> DataStream:
        return self.aggregate(AvgAggregator(dtype or torch.float64),
                              value_column=value_column,
                              output_column=output_column or value_column,
                              name="window-avg")

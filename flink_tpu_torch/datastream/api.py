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
timestamps, sessions, sinks, the two-input, async, iteration and host
evicting operators) need no device.  The joins take it unresolved: their
device lane (``FLINK_TPU_DEVICE_JOIN=1``) resolves it when it runs.  The
environment's ``mesh`` (a :class:`flink_tpu_torch.parallel.mesh.DeviceMesh`)
routes keyed windows and sessions to the mesh operators
(``parallel/mesh_runtime.py``), whose blocks sit on the mesh's devices.
``env.execute_cluster(...)`` runs the job on the in-process MiniCluster
(``cluster/minicluster.py``), one thread per subtask, with aligned or
unaligned, full or incremental checkpoints and restarts; it resolves the
environment's device before it deploys, so it raises without a card unless
the CPU was asked for.
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
           "IterativeStream", "ConnectedStreams", "JoinBuilder",
           "IntervalJoinBuilder", "LATER"]

#: the routes of the JAX API whose modules later slices bring, by the item
#: of ROADMAP.md Queue A that clears each (every route is ported)
LATER: Dict[str, str] = {}


class StreamExecutionEnvironment:
    """``StreamExecutionEnvironment`` analog: source factories + execute().
    ``device`` is where its device operators run (None: the card)."""

    def __init__(self, config: Optional[Configuration] = None,
                 parallelism: int = 1, max_parallelism: int = 128,
                 mesh=None, device: DeviceLike = None):
        self.config = config or Configuration()
        self.parallelism = parallelism
        self.max_parallelism = max_parallelism
        self.device = device
        self._sinks: List[Transformation] = []
        self.checkpoint_interval_ms = 0
        self.checkpoint_storage = None
        #: a DeviceMesh: keyed window and session state splits over it by
        #: key group, and keyed records ride the bucketed exchange
        #: (parallel/mesh_runtime.py)
        self.mesh = mesh

    def set_mesh(self, mesh=None, n_devices: Optional[int] = None
                 ) -> "StreamExecutionEnvironment":
        """Run keyed window aggregations sharded over a device mesh (key
        groups -> mesh positions).  With no arguments, a mesh over every
        visible card; ``n_devices`` more cards than are visible raises (a
        mesh passed in, ``make_mesh(devices=["cuda:0"] * 4)``, puts several
        blocks on one card)."""
        if mesh is None:
            from flink_tpu_torch.parallel.mesh import make_mesh
            mesh = make_mesh(n_devices)
        self.mesh = mesh
        return self

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

    def execute_cluster(self, job_name: str = "job",
                        restore: Optional[Dict[str, Any]] = None,
                        checkpoint_interval_ms: Optional[int] = None,
                        storage=None, unaligned: bool = False,
                        restart_attempts: int = 0, timeout_s: float = 300.0,
                        tolerable_failed_checkpoints: int = 0,
                        checkpoint_timeout_s: float = 60.0,
                        alignment_timeout_ms: Optional[float] = None,
                        alignment_queue_max: Optional[int] = None,
                        channel_capacity: int = 32,
                        incremental: bool = False):
        """Run on the in-process MiniCluster with real parallelism (one
        thread per subtask, channels and partitioners between them), the
        multi-node semantics path (``MiniCluster.java`` analog); returns
        its ``JobResult`` (the cluster is ``self._last_cluster``).

        The job's device operators run on the environment's device,
        resolved here: with none named, the card, and without one this
        raises.  ``incremental=True`` (or ``state.backend.incremental``)
        ships delta checkpoints; ``alignment_timeout_ms`` enables
        aligned-with-timeout unaligned checkpoints (0 = unaligned from the
        first barrier, like ``unaligned=True``); ``alignment_queue_max``
        caps the per-subtask blocked-channel alignment buffer."""
        from flink_tpu_torch.cluster.minicluster import MiniCluster

        self.operator_device()
        plan = self.get_stream_graph(job_name).to_plan()
        cluster = MiniCluster(
            checkpoint_storage=storage or self.checkpoint_storage,
            checkpoint_interval_ms=(
                checkpoint_interval_ms if checkpoint_interval_ms is not None
                else self.checkpoint_interval_ms),
            unaligned=unaligned, restart_attempts=restart_attempts,
            tolerable_failed_checkpoints=tolerable_failed_checkpoints,
            checkpoint_timeout_s=checkpoint_timeout_s,
            alignment_timeout_ms=alignment_timeout_ms,
            alignment_queue_max=alignment_queue_max,
            channel_capacity=channel_capacity, config=self.config,
            incremental=incremental)
        self._last_cluster = cluster
        return cluster.execute(plan, restore=restore, timeout_s=timeout_s)


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

    def iterate(self, max_wait_ms: int = 200) -> "IterativeStream":
        """Streaming iteration (``DataStream.iterate`` analog): returns a
        stream that unions this one with a feedback edge; wire the loop body
        back with ``close_with(feedback_stream)``."""
        from flink_tpu_torch.operators.iteration import (FeedbackQueue,
                                                         FeedbackSource)

        q = FeedbackQueue()
        fb = self.env.from_source(FeedbackSource(q, max_wait_ms),
                                  "iteration-head")
        unioned = self.union(fb)
        return IterativeStream(self.env, unioned.transformation, q)

    # ------------------------------------------------- two-input operations
    def connect(self, other: "DataStream") -> "ConnectedStreams":
        """Two streams, one two-input operator (``ConnectedStreams``)."""
        return ConnectedStreams(self.env, self, other)

    def connect_broadcast(self, rules: "DataStream", fn,
                          name: str = "broadcast-connect") -> "DataStream":
        """Broadcast state pattern: ``rules`` replicates to every subtask;
        ``fn`` is a BroadcastProcessFunction."""
        from flink_tpu_torch.operators.co import BroadcastConnectOperator

        t = Transformation(
            name=name,
            operator_factory=lambda: BroadcastConnectOperator(fn, name),
            inputs=[self.transformation, rules.transformation],
            input_partitionings=[Partitioning.FORWARD, Partitioning.BROADCAST],
            input_key_columns=[None, None],
            parallelism=self.env.parallelism, chainable=False,
            max_parallelism=self.env.max_parallelism)
        return DataStream(self.env, t)

    def join(self, other: "DataStream") -> "JoinBuilder":
        """``a.join(b).where(k).equal_to(k2).window(w).apply(fn)``."""
        return JoinBuilder(self.env, self, other, cogroup=False)

    def co_group(self, other: "DataStream") -> "JoinBuilder":
        return JoinBuilder(self.env, self, other, cogroup=True)

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
                   ordered: bool = True,
                   name: str = "async-wait") -> "DataStream":
        """Async I/O (``AsyncDataStream.orderedWait/unorderedWait``):
        ``fn(cols) -> cols`` runs on a worker pool, one task a batch."""
        from flink_tpu_torch.operators.async_io import AsyncWaitOperator

        t = self._then(name, lambda: AsyncWaitOperator(
            fn, capacity=capacity, timeout_ms=timeout_ms, ordered=ordered,
            name=name), chainable=False)
        return DataStream(self.env, t)

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


class IterativeStream(DataStream):
    """Result of ``iterate()``: a stream with an open feedback edge."""

    def __init__(self, env, transformation, queue):
        super().__init__(env, transformation)
        self.queue = queue

    def close_with(self, feedback: DataStream) -> None:
        """Attach the feedback edge (``IterativeStream.closeWith``)."""
        from flink_tpu_torch.operators.iteration import FeedbackSinkOperator

        q = self.queue
        t = feedback._then("iteration-tail",
                           lambda: FeedbackSinkOperator(q), chainable=False)
        t.is_sink = True
        self.env._register_sink(t)


class ConnectedStreams:
    """``DataStream.connect`` result: map/flat_map/process over two inputs."""

    def __init__(self, env: StreamExecutionEnvironment, left: DataStream,
                 right: DataStream):
        self.env = env
        self.left = left
        self.right = right

    def _two_input(self, name: str, factory) -> DataStream:
        t = Transformation(
            name=name, operator_factory=factory,
            inputs=[self.left.transformation, self.right.transformation],
            parallelism=self.env.parallelism, chainable=False,
            max_parallelism=self.env.max_parallelism)
        return DataStream(self.env, t)

    def map(self, fn1, fn2, name: str = "co-map") -> DataStream:
        from flink_tpu_torch.operators.co import CoMapOperator
        return self._two_input(name, lambda: CoMapOperator(fn1, fn2, name))

    def flat_map(self, fn1, fn2, name: str = "co-flat-map") -> DataStream:
        from flink_tpu_torch.operators.co import CoFlatMapOperator
        return self._two_input(name,
                               lambda: CoFlatMapOperator(fn1, fn2, name))

    def process(self, fn, name: str = "co-process") -> DataStream:
        from flink_tpu_torch.operators.co import CoProcessOperator
        return self._two_input(name, lambda: CoProcessOperator(fn, name))


class JoinBuilder:
    """``a.join(b).where(k).equal_to(k).window(w).apply(fn)``: the
    JoinedStreams/CoGroupedStreams fluent chain, onto
    :class:`flink_tpu_torch.operators.joins.WindowJoinOperator`."""

    def __init__(self, env, left: DataStream, right: DataStream,
                 cogroup: bool):
        self.env = env
        self.left = left
        self.right = right
        self.cogroup = cogroup
        self._left_key: Optional[str] = None
        self._right_key: Optional[str] = None
        self._assigner: Optional[WindowAssigner] = None

    def where(self, key_column: str) -> "JoinBuilder":
        self._left_key = key_column
        return self

    def equal_to(self, key_column: str) -> "JoinBuilder":
        self._right_key = key_column
        return self

    def window(self, assigner: WindowAssigner) -> "JoinBuilder":
        self._assigner = assigner
        return self

    def apply(self, fn=None, name: str = "window-join") -> DataStream:
        from flink_tpu_torch.operators.joins import WindowJoinOperator

        if self._left_key is None or self._right_key is None:
            raise ValueError("join needs .where(...) and .equal_to(...)")
        assigner = self._assigner
        if assigner is None:
            raise ValueError("join needs .window(...)")
        if self.cogroup and fn is None:
            raise ValueError("co_group needs an apply function "
                             "fn(key, window, left_rows, right_rows)")
        lk, rk, cg = self._left_key, self._right_key, self.cogroup
        device = self.env.device
        t = Transformation(
            name=name,
            operator_factory=lambda: WindowJoinOperator(
                assigner, lk, rk, apply_fn=fn, cogroup=cg, name=name,
                device=device),
            inputs=[self.left.transformation, self.right.transformation],
            input_partitionings=[Partitioning.HASH, Partitioning.HASH],
            input_key_columns=[lk, rk],
            parallelism=self.env.parallelism, chainable=False,
            max_parallelism=self.env.max_parallelism)
        return DataStream(self.env, t)


class IntervalJoinBuilder:
    """``a.interval_join(b).between(lo, hi).process(fn)``, onto
    :class:`flink_tpu_torch.operators.joins.IntervalJoinOperator`."""

    def __init__(self, env, left: "KeyedStream", right: "KeyedStream"):
        self.env = env
        self.left = left
        self.right = right
        self._lower = 0
        self._upper = 0

    def between(self, lower_ms: int, upper_ms: int) -> "IntervalJoinBuilder":
        self._lower, self._upper = lower_ms, upper_ms
        return self

    def process(self, fn=None, name: str = "interval-join") -> DataStream:
        from flink_tpu_torch.operators.joins import IntervalJoinOperator

        lk = self.left.key_column
        rk = self.right.key_column
        lo, hi = self._lower, self._upper
        device = self.env.device
        t = Transformation(
            name=name,
            operator_factory=lambda: IntervalJoinOperator(
                lk, rk, lo, hi, output_fn=fn, name=name, device=device),
            inputs=[self.left.transformation, self.right.transformation],
            input_partitionings=[Partitioning.HASH, Partitioning.HASH],
            input_key_columns=[lk, rk],
            parallelism=self.env.parallelism, chainable=False,
            max_parallelism=self.env.max_parallelism)
        return DataStream(self.env, t)


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

    def interval_join(self, other: "KeyedStream") -> IntervalJoinBuilder:
        """``a.interval_join(b).between(lo, hi).process()``."""
        return IntervalJoinBuilder(self.env, self, other)

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
        ``state.backend`` in the environment config (heap / spill /
        changelog)."""
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
        self._late_tag: Optional[str] = None
        self._evictor = None

    def trigger(self, trigger: Trigger) -> "WindowedStream":
        self._trigger = trigger
        return self

    def allowed_lateness(self, ms: int) -> "WindowedStream":
        self._allowed_lateness = ms
        return self

    def side_output_late_data(self, tag) -> "WindowedStream":
        """Route beyond-lateness records to a side output instead of
        dropping them (``sideOutputLateData`` analog); read them downstream
        with ``get_side_output(tag)``."""
        from flink_tpu_torch.core.batch import OutputTag

        self._late_tag = tag.name if isinstance(tag, OutputTag) else str(tag)
        return self

    def evictor(self, evictor) -> "WindowedStream":
        """Raw-element window path with eviction (``evictor(...)`` analog):
        ``aggregate``/``sum``/``count``/... with a Count/Time evictor run the
        device lane (``operators/evicting_device.py``); any evictor works
        with the host ``apply`` lane (``operators/evicting_window.py``)."""
        self._evictor = evictor
        return self

    def apply(self, fn, name: str = "window-apply") -> DataStream:
        """``fn(key, window, rows) -> row dict`` over the window's raw
        (evicted) rows: the WindowFunction path, on the host (it buffers
        elements; ``aggregate``/``reduce`` are the incremental lanes)."""
        from flink_tpu_torch.operators.evicting_window import \
            EvictingWindowOperator

        if self._trigger is not None:
            raise ValueError("custom triggers are not supported on the "
                             "raw-element apply() path yet; use aggregate()")
        if self._late_tag is not None:
            raise ValueError("side_output_late_data is not supported on the "
                             "raw-element apply() path yet; use aggregate()")
        # the fire-time compute is the user's row function, so the buffers
        # stay on the host; a mesh adds no parallelism to it
        if self.keyed.env.mesh is not None:
            import warnings
            warnings.warn(
                "raw-element apply() buffers and fires on the host (user "
                "row function): the env mesh adds no device parallelism to "
                "this operator; scale it with process parallelism (key-group"
                " partitioned, rescale-safe)", stacklevel=2)
        assigner = self.assigner
        key_col = self.keyed.key_column
        ev = self._evictor
        lateness = self._allowed_lateness

        def factory():
            # evictors can hold per-fire scratch: every subtask gets its own
            return EvictingWindowOperator(assigner, copy.deepcopy(ev),
                                          key_col, fn, name,
                                          allowed_lateness_ms=lateness)

        return DataStream(self.keyed.env, self.keyed._then(name, factory))

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
        ``queryable`` registers the operator's state under that name with
        the queryable serving tier: fired values become readable over the
        batched lookup protocol and REST at ``live`` and (when checkpoints
        run) ``checkpoint`` consistency."""
        keyed, assigner = self.keyed, self.assigner
        env = keyed.env
        trigger, lateness = self._trigger, self._allowed_lateness
        late_tag = self._late_tag
        ev = self._evictor
        if (paging is not None or emit_tier is not None) and (
                ev is not None or env.mesh is not None
                or not hasattr(assigner, "pane_of")):
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
            if trigger is not None or late_tag is not None:
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
            if env.mesh is not None:
                import warnings
                warnings.warn(
                    "evictor()+aggregate() runs on a single device (the "
                    "element buffer is not mesh-sharded yet); the env mesh "
                    "is ignored for this operator", stacklevel=2)
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
            session_mesh = env.mesh

            def factory():
                kwargs = dict(
                    key_column=keyed.key_column,
                    value_column=value_column, value_selector=value_selector,
                    allowed_lateness_ms=lateness,
                    output_column=output_column, name=name,
                    late_output_tag=late_tag)
                if session_mesh is not None:
                    from flink_tpu_torch.parallel.mesh_runtime import \
                        MeshSessionWindowOperator
                    return MeshSessionWindowOperator(
                        assigner, agg, mesh=session_mesh, **kwargs)
                return SessionWindowOperator(assigner, agg, **kwargs)
        else:
            mesh = env.mesh

            def factory():
                kwargs = dict(
                    assigner=assigner, agg=agg, key_column=keyed.key_column,
                    value_column=value_column, value_selector=value_selector,
                    allowed_lateness_ms=lateness, trigger=trigger,
                    output_column=output_column, name=name,
                    late_output_tag=late_tag)
                if mesh is not None:
                    # the blocks sit on the mesh's devices
                    from flink_tpu_torch.parallel.mesh_runtime import \
                        MeshWindowAggOperator
                    return MeshWindowAggOperator(mesh=mesh,
                                                 device_probe=device_probe,
                                                 queryable=queryable,
                                                 superbatch=superbatch,
                                                 **kwargs)
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

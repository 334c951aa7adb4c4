"""DataSet API: bounded batch processing, columnar + vectorized.

Analog of the reference's DataSet stack (``flink-java``
``ExecutionEnvironment``/``DataSet`` + ``flink-optimizer`` +
``runtime/operators/`` drivers — map/reduce/join/cogroup/cross, external
sort, hybrid hash join).  TPU-first redesign: a dataset IS a columnar
``RecordBatch``; every operator is a whole-array transform (argsort-based
sort, segment reductions for grouping, vectorized equi-join), so the "37
drivers + ManagedMemory sort/hash code" collapse into array programs that
XLA/numpy execute directly.

Plans are lazy: transformations build a small DAG; ``collect()``/``execute``
runs it through the optimizer (``dataset/optimizer.py``) which picks join
strategies and can ``explain()`` the physical plan.

The port's copy of ``flink_tpu/dataset/api.py``.  The plan runs on the host
in numpy, as JAX's does; the equi-join's device lane
(``operators/joins._join_pairs`` under ``FLINK_TPU_DEVICE_JOIN=1``, off by
default as in JAX) runs on the environment's ``device``: ``None`` is the
card, as in every entry point of the port, resolved only when that lane
runs.  A plan's joins carry their environment's device and its iterations
the environment itself, so an iteration's supersteps join on the caller's
device under its config.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from flink_tpu_torch import DeviceLike
from flink_tpu_torch.core.batch import RecordBatch


@dataclass
class BatchOp:
    """One node of the batch plan DAG."""

    kind: str
    args: Dict[str, Any]
    inputs: List["BatchOp"] = field(default_factory=list)
    #: filled by the optimizer: chosen physical strategy + size estimate
    strategy: Optional[str] = None
    est_rows: Optional[int] = None


class ExecutionEnvironment:
    """``ExecutionEnvironment.getExecutionEnvironment`` analog.  ``device``
    is where the equi-join's device lane runs (``None``: the card)."""

    def __init__(self, config=None, device: DeviceLike = None):
        from flink_tpu_torch.config.config_option import Configuration

        #: governs batch exchanges (ShuffleOptions) and future knobs
        self.config = config if config is not None else Configuration()
        self.device = device

    @staticmethod
    def get_execution_environment(config=None, device: DeviceLike = None
                                  ) -> "ExecutionEnvironment":
        return ExecutionEnvironment(config, device)

    def from_columns(self, columns: Dict[str, Any]) -> "DataSet":
        cols = {k: np.asarray(v) for k, v in columns.items()}
        return DataSet(self, BatchOp("source", {"batch": RecordBatch(cols)}))

    def from_rows(self, rows: Sequence[Dict[str, Any]]) -> "DataSet":
        return DataSet(self, BatchOp(
            "source", {"batch": RecordBatch.from_rows(list(rows))}))

    def read_file(self, path: str, format: str = "csv", **kw) -> "DataSet":
        return DataSet(self, BatchOp("read", {"path": path, "format": format,
                                              "kw": kw}))

    def generate_sequence(self, start: int, end: int) -> "DataSet":
        # lazy: the streamed executor materializes only budget-sized chunks
        # (``env.generateSequence`` analog)
        return DataSet(self, BatchOp("sequence", {"start": int(start),
                                                  "end": int(end)}))


class DataSet:
    def __init__(self, env: ExecutionEnvironment, op: BatchOp):
        self.env = env
        self.op = op

    def _then(self, kind: str, **args) -> "DataSet":
        return DataSet(self.env, BatchOp(kind, args, [self.op]))

    # -- row-wise -----------------------------------------------------------
    def map(self, fn: Callable[[Dict[str, Any]], Dict[str, Any]]) -> "DataSet":
        return self._then("map", fn=fn)

    def filter(self, fn: Callable[[Dict[str, Any]], np.ndarray]) -> "DataSet":
        return self._then("filter", fn=fn)

    def flat_map(self, fn) -> "DataSet":
        return self._then("flat_map", fn=fn)

    def project(self, *columns: str) -> "DataSet":
        return self._then("project", columns=list(columns))

    # -- grouping / aggregation --------------------------------------------
    def group_by(self, *key_columns: str) -> "GroupedDataSet":
        return GroupedDataSet(self, list(key_columns))

    def distinct(self, *columns: str) -> "DataSet":
        return self._then("distinct", columns=list(columns) or None)

    def sum(self, column: str) -> "DataSet":
        return self._then("global_agg", column=column, how="sum")

    def min(self, column: str) -> "DataSet":
        return self._then("global_agg", column=column, how="min")

    def max(self, column: str) -> "DataSet":
        return self._then("global_agg", column=column, how="max")

    def count(self) -> int:
        # streaming terminal: never holds the result set
        return sum(len(b) for b in self.stream_batches())

    def reduce(self, fn: Callable[[Dict, Dict], Dict]) -> "DataSet":
        return self._then("global_reduce", fn=fn)

    # -- binary -------------------------------------------------------------
    def join(self, other: "DataSet") -> "JoinOperatorBuilder":
        return JoinOperatorBuilder(self, other, how="inner")

    def left_outer_join(self, other: "DataSet") -> "JoinOperatorBuilder":
        return JoinOperatorBuilder(self, other, how="left")

    def right_outer_join(self, other: "DataSet") -> "JoinOperatorBuilder":
        return JoinOperatorBuilder(self, other, how="right")

    def full_outer_join(self, other: "DataSet") -> "JoinOperatorBuilder":
        return JoinOperatorBuilder(self, other, how="full")

    def co_group(self, other: "DataSet") -> "JoinOperatorBuilder":
        return JoinOperatorBuilder(self, other, how="cogroup")

    def cross(self, other: "DataSet") -> "DataSet":
        return DataSet(self.env, BatchOp("cross", {},
                                         [self.op, other.op]))

    def union(self, other: "DataSet") -> "DataSet":
        return DataSet(self.env, BatchOp("union", {}, [self.op, other.op]))

    # -- physical partitioning ----------------------------------------------
    def partition_by_hash(self, *columns: str, num_partitions: int = 0,
                          service: Optional[str] = None) -> "DataSet":
        """``DataSet.partitionByHash`` analog: route rows into hash
        partitions through the configured shuffle service
        (``shuffle.service`` — sort-merge spilled blocking partitions by
        default; ``service=`` overrides per-exchange).  ``num_partitions``
        0 derives the count from the size estimate and the row budget.
        Downstream :meth:`map_partition` sees one partition at a time."""
        return self._then("partition_hash", columns=list(columns),
                          n=int(num_partitions), service=service,
                          config=self.env.config)

    def map_partition(self, fn: Callable[[RecordBatch], RecordBatch]
                      ) -> "DataSet":
        """``DataSet.mapPartition`` analog, vectorized: ``fn`` receives one
        whole partition as a RecordBatch and returns a RecordBatch.  Over
        a :meth:`partition_by_hash` input each hash partition is one call
        (peak memory = one partition); otherwise the full dataset is a
        single partition."""
        return self._then("map_partition", fn=fn)

    # -- ordering -----------------------------------------------------------
    def sort_partition(self, column: str, ascending: bool = True) -> "DataSet":
        return self._then("sort", column=column, ascending=ascending)

    def first_n(self, n: int) -> "DataSet":
        return self._then("first_n", n=n)

    # -- iterations (BSP) ----------------------------------------------------
    def iterate(self, max_iterations: int,
                step: Callable[["DataSet"], "DataSet"],
                termination: Optional[Callable[[RecordBatch, RecordBatch], bool]] = None
                ) -> "DataSet":
        """Bulk iteration (``DataSet.iterate`` analog): ``step`` maps the
        loop dataset to the next superstep; stops at ``max_iterations`` or
        when ``termination(prev_batch, next_batch)`` returns True."""
        return DataSet(self.env, BatchOp(
            "bulk_iterate", {"max_iterations": max_iterations, "step": step,
                             "termination": termination, "env": self.env},
            [self.op]))

    def delta_iterate(self, workset: "DataSet", key_column: str,
                      max_iterations: int,
                      step: Callable[["DataSet", "DataSet"],
                                     Tuple["DataSet", "DataSet"]]) -> "DataSet":
        """Delta iteration (``DataSet.iterateDelta``): maintains a keyed
        solution set; each superstep maps (solution, workset) -> (delta,
        next_workset); ends when the workset empties."""
        return DataSet(self.env, BatchOp(
            "delta_iterate", {"key_column": key_column,
                              "max_iterations": max_iterations, "step": step,
                              "env": self.env},
            [self.op, workset.op]))

    # -- execution -----------------------------------------------------------
    def collect_batch(self) -> RecordBatch:
        from flink_tpu_torch.dataset.optimizer import execute_plan
        return execute_plan(self.op)

    def collect(self) -> List[Dict[str, Any]]:
        return self.collect_batch().to_rows()

    def stream_batches(self) -> "Any":
        """Pull-stream execution: an iterator of RecordBatch chunks under
        the row budget (``BatchTask`` driver pipelining analog) — the
        composing form behind ``count``/``write_file``."""
        from flink_tpu_torch.dataset.optimizer import stream_plan
        return stream_plan(self.op)

    def explain(self) -> str:
        from flink_tpu_torch.dataset.optimizer import explain_plan
        return explain_plan(self.op)

    def write_file(self, path: str, format: str = "csv") -> int:
        # streaming sink: chunks flow straight to the writer — a plan
        # larger than memory writes out under the row budget
        from flink_tpu_torch.formats import writer_for
        return writer_for(format)(self.stream_batches(), path)

    def output(self) -> None:
        for row in self.collect():
            print(row)


class GroupedDataSet:
    def __init__(self, ds: DataSet, key_columns: List[str]):
        self.ds = ds
        self.key_columns = key_columns

    def _agg(self, how: str, column: Optional[str]) -> DataSet:
        return DataSet(self.ds.env, BatchOp(
            "group_agg", {"keys": self.key_columns, "column": column,
                          "how": how}, [self.ds.op]))

    def sum(self, column: str) -> DataSet:
        return self._agg("sum", column)

    def min(self, column: str) -> DataSet:
        return self._agg("min", column)

    def max(self, column: str) -> DataSet:
        return self._agg("max", column)

    def count(self) -> DataSet:
        return self._agg("count", None)

    def reduce_group(self, fn: Callable[[Tuple, List[Dict]], Optional[Dict]]
                     ) -> DataSet:
        """``GroupReduceFunction`` analog: fn(key_tuple, rows) -> row."""
        return DataSet(self.ds.env, BatchOp(
            "group_reduce", {"keys": self.key_columns, "fn": fn},
            [self.ds.op]))

    def sort_group(self, column: str, ascending: bool = True) -> "GroupedDataSet":
        g = GroupedDataSet(self.ds._then("sort", column=column,
                                         ascending=ascending),
                           self.key_columns)
        return g

    def first_n(self, n: int) -> DataSet:
        return DataSet(self.ds.env, BatchOp(
            "group_first_n", {"keys": self.key_columns, "n": n},
            [self.ds.op]))


class JoinOperatorBuilder:
    def __init__(self, left: DataSet, right: DataSet, how: str):
        self.left = left
        self.right = right
        self.how = how
        self._where: Optional[List[str]] = None
        self._equal_to: Optional[List[str]] = None
        self._hint: Optional[str] = None

    def where(self, *columns: str) -> "JoinOperatorBuilder":
        self._where = list(columns)
        return self

    def equal_to(self, *columns: str) -> "JoinOperatorBuilder":
        self._equal_to = list(columns)
        return self

    def with_hint(self, hint: str) -> "JoinOperatorBuilder":
        """'broadcast_hash_left'/'broadcast_hash_right'/'sort_merge' — the
        JoinHint analog; otherwise the optimizer chooses by size."""
        self._hint = hint
        return self

    def apply(self, fn: Optional[Callable] = None) -> DataSet:
        if not self._where or not self._equal_to:
            raise ValueError("join needs .where(...).equal_to(...)")
        return DataSet(self.left.env, BatchOp(
            "join", {"how": self.how, "left_keys": self._where,
                     "right_keys": self._equal_to, "fn": fn,
                     "hint": self._hint, "device": self.left.env.device},
            [self.left.op, self.right.op]))

    # joins are commonly finished without a custom function
    def project(self) -> DataSet:
        return self.apply(None)

"""Transformation DAG — the client-side program representation (port of ``flink_tpu/graph/transformations.py``).

Analog of the reference's ``Transformation`` tree that the DataStream API
builds and ``StreamGraphGenerator.java:122`` consumes: every fluent API call
appends a node describing *what* to run (an operator factory) and *how* its
input arrives (a partitioning strategy).  Kept deliberately small: operators
are already batched, so a transformation is (id, name, operator-factory,
parallelism, inputs, partitioning).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

_ids = itertools.count(1)


class Partitioning:
    """Inter-operator exchange strategies (``runtime/partitioner/`` analog)."""

    FORWARD = "forward"        # same subtask, chainable
    HASH = "hash"              # keyBy: route by key group (KeyGroupStreamPartitioner)
    REBALANCE = "rebalance"    # round-robin
    RESCALE = "rescale"        # local round-robin
    BROADCAST = "broadcast"    # replicate to all
    GLOBAL = "global"          # everything to subtask 0
    SHUFFLE = "shuffle"        # random


@dataclass
class Transformation:
    """One node of the program DAG.

    operator_factory: () -> StreamOperator — a fresh operator per subtask.
    key_column:       set on keyed transformations (hash partitioning input).
    """

    name: str
    operator_factory: Optional[Callable[[], Any]]
    inputs: List["Transformation"] = field(default_factory=list)
    partitioning: str = Partitioning.FORWARD
    parallelism: Optional[int] = None
    max_parallelism: Optional[int] = None
    key_column: Optional[str] = None
    is_source: bool = False
    is_sink: bool = False
    source: Any = None           # Source instance for source transformations
    chainable: bool = True
    slot_sharing_group: str = "default"
    uid: Optional[str] = None    # stable operator id for savepoint mapping
    #: two-input transformations: per-input partitioning / key column
    #: overrides (None = use the single transformation-level values)
    input_partitionings: Optional[List[str]] = None
    input_key_columns: Optional[List[Optional[str]]] = None
    id: int = field(default_factory=lambda: next(_ids))

    def with_uid(self, uid: str) -> "Transformation":
        self.uid = uid
        return self

    def all_upstream(self) -> List["Transformation"]:
        """This node + every transitive input, deduped, any order."""
        seen: dict[int, Transformation] = {}
        stack = [self]
        while stack:
            t = stack.pop()
            if t.id in seen:
                continue
            seen[t.id] = t
            stack.extend(t.inputs)
        return list(seen.values())

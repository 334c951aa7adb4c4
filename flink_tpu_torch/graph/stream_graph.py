"""Transformation DAG -> StreamGraph -> ExecutionPlan (with operator chaining) (port of ``flink_tpu/graph/stream_graph.py``).

Mirrors the two-step translation of the reference —
``StreamGraphGenerator.java:122`` (API DAG -> stream graph) and
``StreamingJobGraphGenerator.java:161`` (chaining decision ``isChainable:403``,
job graph) — collapsed into one pass: transformations become ``StreamNode``s;
consecutive FORWARD edges whose endpoints agree on parallelism fuse into a
``ChainedOperator`` (the zero-serialization direct-call path the reference
gets from ``OperatorChain.java:88``; on TPU the chained step functions
additionally jit-fuse because stateless chained ops are jax-traceable).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from flink_tpu_torch.graph.transformations import Partitioning, Transformation
from flink_tpu_torch.operators.base import StreamOperator
from flink_tpu_torch.operators.chain import ChainedOperator


@dataclass
class StreamEdge:
    source_id: int
    target_id: int
    partitioning: str
    key_column: Optional[str] = None
    #: which logical input port of the target this edge feeds (two-input
    #: operators: 0 = left/main, 1 = right/broadcast side)
    input_index: int = 0


@dataclass
class StreamNode:
    id: int
    name: str
    transformation: Transformation
    parallelism: int
    max_parallelism: int
    in_edges: List[StreamEdge] = field(default_factory=list)
    out_edges: List[StreamEdge] = field(default_factory=list)


@dataclass
class PlanVertex:
    """One schedulable vertex: a chain of transformations run as one operator."""

    id: int
    name: str
    chain: List[Transformation]
    parallelism: int
    max_parallelism: int
    is_source: bool
    out_edges: List[StreamEdge] = field(default_factory=list)  # target = vertex id
    in_degree: int = 0
    topo_index: int = -1  # assigned by ExecutionPlan; stable across rebuilds

    def build_operator(self) -> StreamOperator:
        ops = [t.operator_factory() for t in self.chain if t.operator_factory]
        if len(ops) == 1:
            return ops[0]
        return ChainedOperator(ops, name=self.name)

    @property
    def uid(self) -> str:
        """Stable operator id for snapshot mapping (``uid()`` analog): an
        explicit uid on any chain member wins; otherwise topo-position + chain
        name, which is identical for identically-built pipelines (unlike the
        process-global transformation counter)."""
        for t in self.chain:
            if t.uid:
                return t.uid
        return f"v{self.topo_index}:{self.name}"


class StreamGraph:
    def __init__(self, nodes: Dict[int, StreamNode], default_parallelism: int,
                 default_max_parallelism: int, job_name: str = "job"):
        self.nodes = nodes
        self.default_parallelism = default_parallelism
        self.default_max_parallelism = default_max_parallelism
        self.job_name = job_name

    @staticmethod
    def from_sinks(sinks: List[Transformation], default_parallelism: int = 1,
                   default_max_parallelism: int = 128,
                   job_name: str = "job") -> "StreamGraph":
        all_t: Dict[int, Transformation] = {}
        for s in sinks:
            for t in s.all_upstream():
                all_t[t.id] = t
        nodes = {
            t.id: StreamNode(
                id=t.id, name=t.name, transformation=t,
                parallelism=t.parallelism or default_parallelism,
                max_parallelism=t.max_parallelism or default_max_parallelism,
            )
            for t in all_t.values()
        }
        for t in all_t.values():
            for idx, inp in enumerate(t.inputs):
                part = t.partitioning
                key_col = t.key_column
                if t.input_partitionings is not None:
                    part = t.input_partitionings[idx]
                if t.input_key_columns is not None:
                    key_col = t.input_key_columns[idx]
                e = StreamEdge(inp.id, t.id, part, key_col, input_index=idx)
                nodes[inp.id].out_edges.append(e)
                nodes[t.id].in_edges.append(e)
        return StreamGraph(nodes, default_parallelism, default_max_parallelism,
                           job_name)

    # -- chaining ------------------------------------------------------------
    def _chainable(self, edge: StreamEdge) -> bool:
        """``StreamingJobGraphGenerator.isChainable:403`` analog."""
        up, down = self.nodes[edge.source_id], self.nodes[edge.target_id]
        return (
            edge.partitioning == Partitioning.FORWARD
            and up.parallelism == down.parallelism
            and len(down.in_edges) == 1
            and len(up.out_edges) == 1
            and down.transformation.chainable
            and up.transformation.chainable
        )

    def to_plan(self) -> "ExecutionPlan":
        # heads: nodes whose (single) in-edge is not chainable, or sources/joins
        heads: List[StreamNode] = []
        chained_into: Dict[int, int] = {}  # node id -> head id
        for n in self.nodes.values():
            if not n.in_edges or not all(self._chainable(e) for e in n.in_edges):
                heads.append(n)
        # follow chainable out-edges from each head
        vertices: Dict[int, PlanVertex] = {}
        for head in heads:
            chain = [head.transformation]
            chained_into[head.id] = head.id
            cur = head
            while (len(cur.out_edges) == 1 and self._chainable(cur.out_edges[0])):
                cur = self.nodes[cur.out_edges[0].target_id]
                chain.append(cur.transformation)
                chained_into[cur.id] = head.id
            vertices[head.id] = PlanVertex(
                id=head.id,
                name="->".join(t.name for t in chain),
                chain=chain,
                parallelism=head.parallelism,
                max_parallelism=head.max_parallelism,
                is_source=head.transformation.is_source,
            )
        # cross-chain edges
        for head_id, v in vertices.items():
            tail = self.nodes[chained_into_tail(self, head_id, chained_into)]
            for e in tail.out_edges:
                if chained_into.get(e.target_id) != head_id or e.target_id == head_id:
                    tgt_head = chained_into[e.target_id]
                    if tgt_head != head_id:
                        v.out_edges.append(StreamEdge(
                            head_id, tgt_head, e.partitioning, e.key_column,
                            input_index=e.input_index))
                        vertices[tgt_head].in_degree += 1
        return ExecutionPlan(list(vertices.values()), self.job_name)


def chained_into_tail(graph: StreamGraph, head_id: int,
                      chained_into: Dict[int, int]) -> int:
    """Last node id of the chain starting at head_id."""
    cur = graph.nodes[head_id]
    while (len(cur.out_edges) == 1 and
           chained_into.get(cur.out_edges[0].target_id) == head_id):
        cur = graph.nodes[cur.out_edges[0].target_id]
    return cur.id


@dataclass
class ExecutionPlan:
    """Topologically ordered vertices + routed edges — what executors run.

    The analog of the reference's ``JobGraph`` (operator chains as job
    vertices, edges with ship strategies).
    """

    vertices: List[PlanVertex]
    job_name: str = "job"

    def __post_init__(self):
        self.vertices = self._topo_sort(self.vertices)
        self.by_id = {v.id: v for v in self.vertices}
        for i, v in enumerate(self.vertices):
            v.topo_index = i

    @staticmethod
    def _topo_sort(vertices: List[PlanVertex]) -> List[PlanVertex]:
        indeg = {v.id: v.in_degree for v in vertices}
        by_id = {v.id: v for v in vertices}
        ready = sorted([v.id for v in vertices if indeg[v.id] == 0])
        order: List[PlanVertex] = []
        while ready:
            vid = ready.pop(0)
            order.append(by_id[vid])
            for e in by_id[vid].out_edges:
                indeg[e.target_id] -= 1
                if indeg[e.target_id] == 0:
                    ready.append(e.target_id)
        if len(order) != len(vertices):
            raise ValueError("cycle in execution plan")
        return order

    @property
    def sources(self) -> List[PlanVertex]:
        return [v for v in self.vertices if v.is_source]

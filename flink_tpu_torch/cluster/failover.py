"""Restart backoff strategies + pipelined-region computation.

Analogs of ``runtime/executiongraph/failover/flip1/``:
``FixedDelayRestartBackoffTimeStrategy``,
``ExponentialDelayRestartBackoffTimeStrategy``,
``FailureRateRestartBackoffTimeStrategy`` and
``RestartPipelinedRegionFailoverStrategy`` (restart only the connected
pipelined region containing the failed task — here all edges are pipelined,
so a region is a weakly-connected component of the plan).

The port's copy of ``flink_tpu/cluster/failover.py`` (host Python, as JAX's).
"""

from __future__ import annotations

import time
from typing import Dict, List, Set

from flink_tpu_torch.graph.stream_graph import ExecutionPlan


class RestartStrategy:
    def can_restart(self) -> bool:
        raise NotImplementedError

    def delay_ms(self) -> int:
        raise NotImplementedError

    def notify_failure(self) -> None:
        """Record one failure occurrence."""


class NoRestartStrategy(RestartStrategy):
    def can_restart(self) -> bool:
        return False

    def delay_ms(self) -> int:
        return 0


class FixedDelayRestartStrategy(RestartStrategy):
    """``fixed-delay``: at most ``attempts`` restarts, constant delay."""

    def __init__(self, attempts: int, delay_ms: int = 50):
        self.attempts = attempts
        self._delay_ms = delay_ms
        self._failures = 0

    def notify_failure(self) -> None:
        self._failures += 1

    def can_restart(self) -> bool:
        return self._failures <= self.attempts

    def delay_ms(self) -> int:
        return self._delay_ms


class ExponentialDelayRestartStrategy(RestartStrategy):
    """``exponential-delay``: backoff doubles per failure up to a cap and
    resets after a quiet period (``ExponentialDelayRestartBackoffTimeStrategy``)."""

    def __init__(self, initial_delay_ms: int = 50, max_delay_ms: int = 10_000,
                 backoff_multiplier: float = 2.0,
                 reset_after_quiet_ms: int = 60_000,
                 max_attempts: int = 1 << 30):
        self.initial_delay_ms = initial_delay_ms
        self.max_delay_ms = max_delay_ms
        self.backoff_multiplier = backoff_multiplier
        self.reset_after_quiet_ms = reset_after_quiet_ms
        self.max_attempts = max_attempts
        self._failures = 0
        self._current_ms = float(initial_delay_ms)
        self._last_failure = 0.0

    def notify_failure(self) -> None:
        now = time.monotonic()
        if self._last_failure and (now - self._last_failure) * 1000 \
                >= self.reset_after_quiet_ms:
            self._current_ms = float(self.initial_delay_ms)
            self._failures = 0
        elif self._failures:
            self._current_ms = min(float(self.max_delay_ms),
                                   self._current_ms * self.backoff_multiplier)
        self._failures += 1
        self._last_failure = now

    def can_restart(self) -> bool:
        return self._failures <= self.max_attempts

    def delay_ms(self) -> int:
        return int(self._current_ms)


class FailureRateRestartStrategy(RestartStrategy):
    """``failure-rate``: give up when more than ``max_failures`` occur within
    ``interval_ms`` (``FailureRateRestartBackoffTimeStrategy``)."""

    def __init__(self, max_failures: int, interval_ms: int,
                 delay_ms: int = 50):
        self.max_failures = max_failures
        self.interval_ms = interval_ms
        self._delay_ms = delay_ms
        self._times: List[float] = []

    def notify_failure(self) -> None:
        now = time.monotonic()
        self._times.append(now)
        cutoff = now - self.interval_ms / 1000.0
        self._times = [t for t in self._times if t >= cutoff]

    def can_restart(self) -> bool:
        return len(self._times) <= self.max_failures

    def delay_ms(self) -> int:
        return self._delay_ms


# ---------------------------------------------------------------------------
# pipelined regions
# ---------------------------------------------------------------------------

def pipelined_regions(plan: ExecutionPlan) -> List[Set[str]]:
    """Weakly-connected components of the plan, as vertex-uid sets
    (``RestartPipelinedRegionFailoverStrategy`` regions: every edge here is
    PIPELINED, so regions are exactly the connected components)."""
    parent: Dict[str, str] = {v.uid: v.uid for v in plan.vertices}

    def find(x: str) -> str:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a: str, b: str) -> None:
        parent[find(a)] = find(b)

    for v in plan.vertices:
        for e in v.out_edges:
            union(v.uid, plan.by_id[e.target_id].uid)
    regions: Dict[str, Set[str]] = {}
    for v in plan.vertices:
        regions.setdefault(find(v.uid), set()).add(v.uid)
    return list(regions.values())


def region_of(plan: ExecutionPlan, vertex_uid: str) -> Set[str]:
    for region in pipelined_regions(plan):
        if vertex_uid in region:
            return region
    raise KeyError(vertex_uid)


def subtask_regions(plan: ExecutionPlan,
                    counts: Dict[str, int]) -> "List[Set[tuple]]":
    """Pipelined regions at SUBTASK granularity — the actual
    ``RestartPipelinedRegionFailoverStrategy`` unit: a forward edge at
    equal parallelism connects producer i to consumer i only (so parallel
    forward chains are independent regions); every other partitioning is
    all-to-all and fuses both vertices' subtasks into one region.
    ``counts``: effective subtask count per vertex uid (sources may run one
    subtask per split)."""
    subs = [(v.uid, i) for v in plan.vertices for i in range(counts[v.uid])]
    parent = {s: s for s in subs}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        parent[find(a)] = find(b)

    for v in plan.vertices:
        for e in v.out_edges:
            tgt = plan.by_id[e.target_id]
            np_, nc = counts[v.uid], counts[tgt.uid]
            if e.partitioning == "forward" and np_ == nc:
                for i in range(np_):
                    union((v.uid, i), (tgt.uid, i))
            else:
                for pi in range(np_):
                    for ci in range(nc):
                        union((v.uid, pi), (tgt.uid, ci))
    regions: Dict[tuple, Set[tuple]] = {}
    for s in subs:
        regions.setdefault(find(s), set()).add(s)
    return list(regions.values())

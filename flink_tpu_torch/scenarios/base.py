"""Scenario protocol: what a named end-to-end application declares.

A scenario is a topology + a sized workload; the harness
(:mod:`flink_tpu_torch.scenarios.harness`) owns everything operational (broker,
autoscaler, chaos, queryable readers, verification).  Keeping the two
apart means ``examples/`` can reuse a scenario's topology pieces without
dragging the harness in, and the harness can drive any scenario the same
way.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.testing.workload import DiurnalSource


@dataclass
class ScenarioSpec:
    """One sized instantiation of a scenario (smoke vs full)."""

    name: str
    records: int
    keys: int
    batch_size: int = 128
    span_ms: int = 20_000
    window_ms: int = 1000
    peak_s: float = 0.004
    trough_s: float = 0.020
    seed: int = 47
    topics: Tuple[str, ...] = ()
    queryable_state: Optional[str] = None
    #: paced lookups/sec the harness's routed binary clients sustain
    #: against ``queryable_state`` while the job runs (0 = no read leg)
    qps_target: float = 0.0
    qps_batch_keys: int = 64
    smoke: bool = False
    extras: Dict[str, Any] = field(default_factory=dict)


class Scenario:
    """Base scenario: subclasses declare the topology and sizes.

    Contract:

    - ``spec(smoke, records=, keys=)`` -> :class:`ScenarioSpec`
    - ``build(env, source, sinks, spec)`` — wire the topology onto the
      environment; ``sinks`` maps each declared topic to a fresh
      transactional sink.
    - ``value_fn(rng, n)`` — the value column's distribution (defaults to
      all ones: summed outputs stay exact in float64, the digest
      convention).
    - ``cross_check(committed, source, spec)`` — scenario-specific output
      validation beyond the control-digest comparison (e.g. the SQL
      TUMBLE cross-check); returns a list of violation strings.
    - ``nemeses(injector, spec, full)`` — arm the chaos schedules to
      inject AT THE PEAK; returns the armed schedules keyed by name
      (``full=True`` adds the heavyweight nemeses the quick tier skips).
    """

    name: str = "scenario"
    budget_section: str = "scenario_cpu"

    def spec(self, smoke: bool, records: Optional[int] = None,
             keys: Optional[int] = None) -> ScenarioSpec:
        raise NotImplementedError

    # -- workload ----------------------------------------------------------
    def value_fn(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return np.ones(n, np.float64)

    def make_source(self, spec: ScenarioSpec,
                    paced: bool = True) -> DiurnalSource:
        """A FRESH diurnal source for one leg — same seed => bit-identical
        stream, so the faulted run and the unfaulted control see the same
        input."""
        return DiurnalSource(spec.records, spec.keys, spec.batch_size,
                             spec.span_ms, peak_s=spec.peak_s,
                             trough_s=spec.trough_s, seed=spec.seed,
                             value_fn=self.value_fn, paced=paced)

    # -- topology ----------------------------------------------------------
    def build(self, env, source, sinks: Dict[str, Any],
              spec: ScenarioSpec) -> None:
        raise NotImplementedError

    def plan(self, parallelism: int, source, sinks: Dict[str, Any],
             spec: ScenarioSpec):
        from flink_tpu_torch.datastream.api import StreamExecutionEnvironment

        env = StreamExecutionEnvironment()
        env.set_parallelism(parallelism)
        self.build(env, source, sinks, spec)
        return env.get_stream_graph(f"scenario-{self.name}").to_plan()

    # -- chaos at the peak -------------------------------------------------
    def nemeses(self, injector, spec: ScenarioSpec,
                full: bool = False) -> Dict[str, Any]:
        """Default nemesis set, armed when the curve reaches its peak: a
        worker kill (one subtask dies mid-stream -> region restart from
        the last cut), bursty ``SlowConsumer`` drain stalls, and a
        ``KillDuringRescale`` priming the NEXT rescale's redistribute to
        die (absorbed by the lifecycle's idempotent re-trigger).
        ``full=True`` adds ``WedgedDevice`` on the hot-path dispatch —
        the watchdog/quarantine/degrade path — which costs seconds of
        wall clock and is reserved for the bench tier."""
        from flink_tpu_torch.testing import chaos

        armed = {
            "worker_kill": injector.inject(
                "subtask.run", chaos.FailTimes(1, message="scenario "
                                               "worker kill at peak")),
            "kill_during_rescale": injector.inject(
                "rescale.redistribute", chaos.KillDuringRescale(at=1)),
        }
        # (the SlowConsumer leg rides the harness's consumer-cost schedule
        # on ``channel.recv`` — one point holds one schedule, so the
        # harness arms its burst mode rather than replacing the cost)
        if full:
            armed["wedged_device"] = injector.inject(
                "device.dispatch", chaos.WedgedDevice(at=1))
        return armed

    # -- verification ------------------------------------------------------
    def cross_check(self, committed: Dict[str, List[dict]], source,
                    spec: ScenarioSpec) -> List[str]:
        return []

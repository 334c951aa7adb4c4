"""Scenario suite: named end-to-end exactly-once applications under a
diurnal load curve (port of ``flink_tpu/scenarios``; each scenario's
StreamExecutionEnvironment resolves its device as every entry point does:
the card unless the CPU is asked for).

Each scenario composes the subsystems the repo has grown — vectorized
CEP, session windows + SQL, the queryable serving tier, transactional
Kafka sinks, the reactive autoscaler, chaos — into ONE gated workload:

- :mod:`~flink_tpu_torch.scenarios.fraud_detection`: diurnal transaction
  stream -> CEP bait/strike pattern -> transactional alert sink, alerts
  also live-queryable.
- :mod:`~flink_tpu_torch.scenarios.sessionized_analytics`: clickstream ->
  session windows + a tumbling aggregate cross-checked against the SQL
  planner's TUMBLE answer -> transactional sinks.
- :mod:`~flink_tpu_torch.scenarios.feature_store`: high-cardinality window
  aggregates published queryable, read concurrently by routed binary
  clients at a paced QPS while the job runs.

The harness (:mod:`~flink_tpu_torch.scenarios.harness`) owns the lifecycle:
build the job, ramp the shared diurnal generator, let the
``ReactiveAutoscaler`` react to the peak, inject nemeses DURING the
peak, and verify the committed end-to-end output is exactly-once —
digest-identical to an unfaulted control run over the same generated
stream.
"""

from flink_tpu_torch.scenarios.base import Scenario, ScenarioSpec
from flink_tpu_torch.scenarios.feature_store import FeatureStoreScenario
from flink_tpu_torch.scenarios.fraud_detection import FraudDetectionScenario
from flink_tpu_torch.scenarios.harness import ScenarioHarness
from flink_tpu_torch.scenarios.sessionized_analytics import \
    SessionizedAnalyticsScenario

SCENARIOS = {
    "fraud_detection": FraudDetectionScenario,
    "sessionized_analytics": SessionizedAnalyticsScenario,
    "feature_store": FeatureStoreScenario,
}


def get_scenario(name: str) -> Scenario:
    """Instantiate a scenario by its registered name."""
    try:
        return SCENARIOS[name]()
    except KeyError:
        raise ValueError(f"unknown scenario {name!r} "
                         f"(have: {', '.join(sorted(SCENARIOS))})") from None


__all__ = ["SCENARIOS", "Scenario", "ScenarioHarness", "ScenarioSpec",
           "FeatureStoreScenario", "FraudDetectionScenario",
           "SessionizedAnalyticsScenario", "get_scenario"]

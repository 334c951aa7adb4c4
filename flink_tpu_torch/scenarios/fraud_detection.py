"""fraud_detection scenario: diurnal transaction stream -> vectorized CEP
bait/strike pattern -> transactional Kafka alert sink (2PC EOS), alerts
also live-queryable (windowed per-account alert totals).

The pattern is the flink-walkthroughs fraud shape: a SMALL "bait"
transaction followed by a LARGE "strike" on the same account within a
few windows.  ``examples/fraud_detection.py`` imports
:func:`fraud_pattern`/:func:`detect_frauds` so the shipped example and
this gated workload cannot diverge.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from flink_tpu_torch.scenarios.base import Scenario, ScenarioSpec

#: the bait/strike thresholds over the scenario's uniform [0, 600) amounts
SMALL_MAX = 30.0
LARGE_MIN = 570.0


def fraud_pattern(window_ms: int, amount_column: str = "v"):
    """Bait -> strike on the same key within 4 windows (the shape
    ``bench.py --cep`` benchmarks and the walkthrough example detects)."""
    from flink_tpu_torch.cep import Pattern

    return (Pattern.begin("small")
            .where(lambda c: np.asarray(c[amount_column]) < SMALL_MAX)
            .followed_by("large")
            .where(lambda c: np.asarray(c[amount_column]) > LARGE_MIN)
            .within(4 * window_ms))


def detect_frauds(keyed_stream, window_ms: int, amount_column: str = "v",
                  vectorized: str = "auto"):
    """The scenario's CEP stage over any keyed transaction stream:
    returns the alert DataStream ``{<key>, bait, amount}`` (match
    timestamps ride the batch timestamps)."""
    from flink_tpu_torch.cep import CEP

    key_column = keyed_stream.key_column

    def select_alert(m):
        return {key_column: m["small"][0][key_column],
                "bait": m["small"][0][amount_column],
                "amount": m["large"][0][amount_column]}

    return CEP.pattern(
        keyed_stream,
        fraud_pattern(window_ms, amount_column)).select(
            select_alert, name="fraud-detect", vectorized=vectorized)


class FraudDetectionScenario(Scenario):
    name = "fraud_detection"
    budget_section = "scenario_fraud_cpu"

    def spec(self, smoke: bool, records: Optional[int] = None,
             keys: Optional[int] = None) -> ScenarioSpec:
        return ScenarioSpec(
            name=self.name,
            records=records or (60_000 if smoke else 400_000),
            keys=keys or (997 if smoke else 20_011),
            batch_size=128 if smoke else 256,
            topics=("alerts",),
            queryable_state="fraud_alerts",
            qps_target=200.0,
            seed=47, smoke=smoke)

    def value_fn(self, rng: np.random.Generator, n: int) -> np.ndarray:
        # uniform transaction amounts over [0, 600): ~5% bait, ~5% strike
        return rng.random(n) * 600.0

    def build(self, env, source, sinks, spec: ScenarioSpec) -> None:
        import torch

        from flink_tpu_torch.connectors.sinks import FunctionSink
        from flink_tpu_torch.core.functions import SumAggregator
        from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

        tx = (env.from_source(source)
              .assign_timestamps_and_watermarks(0, timestamp_column="t")
              .key_by("k"))
        alerts = detect_frauds(tx, spec.window_ms)
        # committed end-to-end output: every alert exactly once
        alerts.add_sink(sinks["alerts"])
        # live-queryable per-account alert totals (windowed so fires — and
        # therefore live-view publishes — happen continuously)
        (alerts.key_by("k")
         .window(TumblingEventTimeWindows.of(spec.window_ms * 4))
         .aggregate(SumAggregator(torch.float64), value_column="amount",
                    output_column="alert_amount",
                    queryable="fraud_alerts")
         .add_sink(FunctionSink(lambda b: None)))

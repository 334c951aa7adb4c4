"""feature_store scenario: high-cardinality windowed feature aggregates
published queryable and committed transactionally, read concurrently by
ROUTED BINARY clients at a paced QPS while the job runs (the
serving tier threaded into a live, autoscaling, chaos-injected job).

The committed ``features`` topic doubles as a ground-truth check: per
``(key, window_start)`` sums must equal the sums computed directly from
the generated stream — not just match the control run.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from flink_tpu_torch.scenarios.base import Scenario, ScenarioSpec


class FeatureStoreScenario(Scenario):
    name = "feature_store"
    budget_section = "scenario_feature_cpu"

    def spec(self, smoke: bool, records: Optional[int] = None,
             keys: Optional[int] = None) -> ScenarioSpec:
        return ScenarioSpec(
            name=self.name,
            records=records or (60_000 if smoke else 500_000),
            keys=keys or (1013 if smoke else 250_007),
            batch_size=128 if smoke else 256,
            topics=("features",),
            queryable_state="features",
            qps_target=500.0 if smoke else 2000.0,
            qps_batch_keys=128,
            seed=59, smoke=smoke)

    def build(self, env, source, sinks, spec: ScenarioSpec) -> None:
        import torch

        from flink_tpu_torch.core.functions import SumAggregator
        from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

        (env.from_source(source)
         .assign_timestamps_and_watermarks(0, timestamp_column="t")
         .key_by("k")
         .window(TumblingEventTimeWindows.of(spec.window_ms))
         .aggregate(SumAggregator(torch.float64), value_column="v",
                    output_column="feature", name="feature-agg",
                    queryable="features")
         .add_sink(sinks["features"]))

    def cross_check(self, committed: Dict[str, List[dict]], source,
                    spec: ScenarioSpec) -> List[str]:
        """Absolute ground truth: committed per-(key, window) sums equal
        the sums computed directly from the generated stream.  The
        expected side is a vectorized groupby (packed int64 codes): the
        full tier sums 500k records, and a per-row Python loop here adds
        seconds to every gated run."""
        ks = np.concatenate([d[0] for d in source._data])
        vs = np.concatenate([d[1] for d in source._data])
        ts = np.concatenate([d[2] for d in source._data])
        ws = (ts // spec.window_ms) * spec.window_ms
        codes = ks.astype(np.int64) * (np.int64(1) << 32) + ws
        uniq, inv = np.unique(codes, return_inverse=True)
        sums = np.bincount(inv, weights=vs)
        expected: Dict[tuple, float] = {
            (int(c >> 32), int(c & 0xFFFFFFFF)): float(s)
            for c, s in zip(uniq.tolist(), sums.tolist())}
        got = {(int(r["k"]), int(r["window_start"])): float(r["feature"])
               for r in committed.get("features", [])}
        viol: List[str] = []
        if len(expected) != len(got):
            viol.append(f"feature ground truth: {len(expected)} expected "
                        f"(key, window) groups vs {len(got)} committed")
        bad = sum(1 for key, s in expected.items()
                  if key not in got or abs(got[key] - s) > 1e-6)
        if bad:
            viol.append(f"feature ground truth: {bad} (key, window) sums "
                        f"diverge from the generated stream")
        return viol

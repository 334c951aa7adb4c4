"""sessionized_analytics scenario: diurnal clickstream -> session windows
AND a tumbling aggregate over the same stream -> transactional Kafka
sinks, with the tumbling branch cross-checked against the SQL planner's
TUMBLE answer over the identical input (the L3/L4 layers must agree on
the same stream).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from flink_tpu_torch.scenarios.base import Scenario, ScenarioSpec


class SessionizedAnalyticsScenario(Scenario):
    name = "sessionized_analytics"
    budget_section = "scenario_session_cpu"

    def spec(self, smoke: bool, records: Optional[int] = None,
             keys: Optional[int] = None) -> ScenarioSpec:
        return ScenarioSpec(
            name=self.name,
            records=records or (60_000 if smoke else 400_000),
            keys=keys or (1009 if smoke else 50_021),
            batch_size=128 if smoke else 256,
            topics=("sessions", "tumble"),
            queryable_state="session_tumble",
            qps_target=200.0,
            seed=53, smoke=smoke,
            extras={"gap_ms": 500})

    def build(self, env, source, sinks, spec: ScenarioSpec) -> None:
        import torch

        from flink_tpu_torch.core.functions import SumAggregator
        from flink_tpu_torch.windowing.assigners import (EventTimeSessionWindows,
                                                   TumblingEventTimeWindows)

        clicks = (env.from_source(source)
                  .assign_timestamps_and_watermarks(0, timestamp_column="t")
                  .key_by("k"))
        # sessionization: per-user activity bursts (gap < window)
        (clicks.window(EventTimeSessionWindows(spec.extras["gap_ms"]))
         .aggregate(SumAggregator(torch.float64), value_column="v",
                    output_column="s", name="sessionize")
         .add_sink(sinks["sessions"]))
        # the same stream through a TUMBLE aggregate — the datastream twin
        # of the SQL query cross-checked below
        (clicks.window(TumblingEventTimeWindows.of(spec.window_ms))
         .aggregate(SumAggregator(torch.float64), value_column="v",
                    output_column="s", name="tumble-agg",
                    queryable="session_tumble")
         .add_sink(sinks["tumble"]))

    def cross_check(self, committed: Dict[str, List[dict]], source,
                    spec: ScenarioSpec) -> List[str]:
        """SQL-vs-datastream: replay the SAME generated stream through the
        SQL planner's TUMBLE (``sql/planner.py``) and diff against the
        committed tumbling-branch rows — the two execution layers must
        produce the identical windowed answer."""
        from flink_tpu_torch.sql.table_env import TableEnvironment

        ks = np.concatenate([d[0] for d in source._data])
        vs = np.concatenate([d[1] for d in source._data])
        ts = np.concatenate([d[2] for d in source._data])
        # each split's timestamps are sorted independently; present the
        # union in global time order — the planner's windowed aggregate
        # treats timestamp regressions as late data, exactly like the
        # datastream job would if one source subtask replayed the past
        order = np.argsort(ts, kind="stable")
        ks, vs, ts = ks[order], vs[order], ts[order]
        t_env = TableEnvironment()
        t_env.register_collection(
            "clicks", columns={"k": ks, "v": vs, "ts": ts})
        sec = spec.window_ms // 1000
        rows = t_env.execute_sql(
            f"SELECT k, TUMBLE_START(ts, INTERVAL '{sec}' SECOND) AS ws, "
            f"SUM(v) AS s FROM clicks "
            f"GROUP BY k, TUMBLE(ts, INTERVAL '{sec}' SECOND)").collect()
        sql_answer = {(int(r["k"]), int(r["ws"])): float(r["s"])
                      for r in rows}
        got = {(int(r["k"]), int(r["window_start"])): float(r["s"])
               for r in committed.get("tumble", [])}
        viol: List[str] = []
        if len(sql_answer) != len(got):
            viol.append(f"SQL TUMBLE cross-check: {len(sql_answer)} SQL "
                        f"groups vs {len(got)} committed rows")
        mismatches = sum(
            1 for key, s in sql_answer.items()
            if key not in got or abs(got[key] - s) > 1e-6)
        if mismatches:
            viol.append(f"SQL TUMBLE cross-check: {mismatches} window "
                        f"groups diverge between the SQL planner and the "
                        f"committed datastream output")
        return viol

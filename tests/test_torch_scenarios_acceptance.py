"""Port parity for the scenario suite's end-to-end acceptance cases: each
of ``tests/test_scenarios.py``'s three scenarios under a diurnal load, the
reactive autoscaler, a worker kill, ``KillDuringRescale`` and
``SlowConsumer`` bursts at the peak, its committed Kafka rows exactly once
and digest-identical to an unfaulted control, on both packages through the
harness of ``tests/test_torch_cluster_cases.py`` (reference marks kept).

``test_fraud_detection_exactly_once_under_kill`` races the machine's load
in either package (ROADMAP Queue C item 6: whether the backpressure-driven
policy decides a rescale before the stream ends depends on how fast the
slowed consumer drains), so its counterpart below runs both packages with
the autoscaler's decisions scripted, as ``tests/test_torch_rescale_cases.py``
does for the rescale acceptance cases: out to the maximum at a set poll of
the first deployment, back in at a set poll of the second.  The scenario,
its nemeses, the control and every assertion stand as written.
"""

import pytest

from test_torch_calibration import verdicts  # noqa: F401 — the fixture
from test_torch_cluster_cases import cases, check_case

ACCEPTANCE = {"test_scenarios": (
    "test_sessionized_analytics_exactly_once_and_sql_crosscheck",
    "test_feature_store_exactly_once_with_routed_reads")}


@pytest.mark.parametrize("ref, cls, fn_name, params",
                         cases(ACCEPTANCE, marks=True))
def test_reference_case(ref, cls, fn_name, params, tmp_path_factory,
                        verdicts):  # noqa: F811 — the fixture
    check_case(ref, cls, fn_name, params, tmp_path_factory, verdicts)


#: the reference case's head, as written
CASE = "def test_fraud_detection_exactly_once_under_kill():\n"

#: the same case with the harness's policy scripted: out to the maximum at
#: poll ``OUT_AT`` of a deployment at the minimum, back in at poll
#: ``IN_AT`` of one at the maximum (after the peak's nemeses arm), once each
SCRIPTED = '''def test_fraud_detection_exactly_once_under_kill(monkeypatch):
    from flink_tpu.cluster import adaptive

    class _ScriptedPolicy(adaptive.AutoscalerPolicy):
        OUT_AT, IN_AT = 12, 40

        def __init__(self, **kw):
            super().__init__(**kw)
            self._polls, self._at, self._done = 0, None, set()

        def observe(self, signals, current):
            if current != self._at:
                self._polls, self._at = 0, current
            self._polls += 1
            if (current == self.min_parallelism and "out" not in self._done
                    and self._polls >= self.OUT_AT):
                self._done.add("out")
                return self.max_parallelism
            if (current == self.max_parallelism and "in" not in self._done
                    and self._polls >= self.IN_AT):
                self._done.add("in")
                return self.min_parallelism
            return None

    monkeypatch.setattr(adaptive, "AutoscalerPolicy", _ScriptedPolicy)
'''


@pytest.mark.chaos
def test_fraud_detection_with_scripted_decisions(tmp_path_factory,
                                                 verdicts):  # noqa: F811
    """``test_scenarios.py::test_fraud_detection_exactly_once_under_kill``
    on both packages with the autoscaler's decisions scripted (see the
    module's docstring): the CEP job rescales 2 -> 4 -> 2 mid-stream, a
    worker dies at the peak, and the committed alerts are exactly once,
    digest-identical to the control, and live-queryable while it runs."""
    check_case("test_scenarios", None,
               "test_fraud_detection_exactly_once_under_kill", {},
               tmp_path_factory, verdicts, patches=((CASE, SCRIPTED),))

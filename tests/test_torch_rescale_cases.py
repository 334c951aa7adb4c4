"""Port parity for adaptive scheduling and the reactive autoscaler: the
reference's cases of ``tests/test_adaptive.py`` and
``tests/test_rescale_under_fire.py``, run through both packages with the
harness of ``tests/test_torch_cluster_cases.py``, each keeping its
reference marks.

The four acceptance cases of ``test_rescale_under_fire.py`` race the
machine's load in either package (ROADMAP Queue C item 6): whether and when
the backpressure-driven policy decides depends on how fast the slowed
consumer drains, so under load ``test_acceptance_autoscaled_2_4_2_exactly_
once`` can miss its scale-in, ``test_acceptance_kill_during_rescale_is_
idempotent`` and ``test_acceptance_rollback_on_redeploy_failure`` their
rescale (no re-trigger, no rollback) and ``test_acceptance_worker_killed_
mid_redeploy`` its window.  Their counterparts below run both packages
with the autoscaler's decisions scripted: a policy that scales out after a
set number of polls of the first deployment and back in after a set number
of polls of the second, so the 2 -> 4 -> 2 path is reached by
construction.  The job, the faults, the control and every exactly-once,
digest, re-trigger and rollback assertion stand as written.
"""

import pytest

import flink_tpu_torch.cluster.distributed  # noqa: F401 — patched by the harness
from test_torch_calibration import verdicts  # noqa: F401 — the fixture
from test_torch_cluster_cases import cases, check_case

#: the reference's policy, as written
POLICY = '''def _acceptance_policy():
    return AutoscalerPolicy(min_parallelism=2, max_parallelism=4,'''

#: the scripted policy the counterparts put in its place: out to the
#: maximum at poll ``OUT_AT`` of a deployment at the minimum, back in at
#: poll ``IN_AT`` of one at the maximum, once each
SCRIPTED = '''class _ScriptedPolicy(AutoscalerPolicy):
    OUT_AT, IN_AT = 12, 12

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


def _acceptance_policy():
    return _ScriptedPolicy(min_parallelism=2, max_parallelism=4,'''


@pytest.mark.parametrize("ref, cls, fn_name, params",
                         cases(("test_adaptive", "test_rescale_under_fire"),
                               marks=True))
def test_reference_case(ref, cls, fn_name, params, tmp_path_factory,
                        verdicts):  # noqa: F811 — the fixture
    check_case(ref, cls, fn_name, params, tmp_path_factory, verdicts)


@pytest.mark.chaos
@pytest.mark.parametrize("fn_name", [
    "test_acceptance_autoscaled_2_4_2_exactly_once",
    "test_acceptance_kill_during_rescale_is_idempotent",
    "test_acceptance_rollback_on_redeploy_failure",
    "test_acceptance_worker_killed_mid_redeploy"])
def test_acceptance_with_scripted_decisions(fn_name, tmp_path_factory,
                                            verdicts):  # noqa: F811
    """The racy acceptance case on both packages, the autoscaler's
    decisions scripted (see the module's docstring)."""
    check_case("test_rescale_under_fire", None, fn_name, {},
               tmp_path_factory, verdicts, patches=((POLICY, SCRIPTED),))

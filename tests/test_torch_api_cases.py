"""Port parity for the user-facing APIs of the early slices: every case of
the reference's ``tests/test_datastream.py``, ``test_dataset.py`` and
``test_external_batch.py``, run through both packages with the harness of
``tests/test_torch_cluster_cases.py``, each keeping its reference marks
(``test_external_batch.py``'s ``slow`` case stays out of tier 1, as it is
in the reference).
"""

import pytest

from test_torch_calibration import verdicts  # noqa: F401 — the fixture
from test_torch_cluster_cases import cases, check_case

REFERENCE_FILES = ("test_datastream", "test_dataset", "test_external_batch")


@pytest.mark.parametrize("ref, cls, fn_name, params",
                         cases(REFERENCE_FILES, marks=True))
def test_reference_case(ref, cls, fn_name, params, tmp_path_factory,
                        verdicts):  # noqa: F811 — the fixture
    check_case(ref, cls, fn_name, params, tmp_path_factory, verdicts)

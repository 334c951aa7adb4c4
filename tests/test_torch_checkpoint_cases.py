"""Port parity for checkpointing: the reference's checkpoint cases, run
through both packages with the harness of
``tests/test_torch_cluster_cases.py`` (the same records, the same rules).

Each case of ``tests/test_checkpoint.py``, ``test_local_recovery.py``,
``test_incremental_changelog.py``, ``test_savepoint_compat.py`` and
``test_incremental_checkpoints.py`` runs as the reference wrote it on the
JAX package, then with its source importing ``flink_tpu_torch``: window
operators on every tier cut ``window_delta`` increments, the changelog
backend cuts log suffixes, the storages resolve their chains, and the
records (operator outputs and snapshots, increments, resolved chains,
storage loads, fault histories) must be equal, floats bit for bit.  The
checked-in savepoint fixture JAX wrote (``tests/fixtures/savepoint_v1``)
loads in the port.  ``test_process_cluster_incremental_end_to_end`` runs
a two-worker process cluster in each package (the port's workers on the
CPU, shipped by the coordinator).
"""

import pytest

from test_torch_calibration import verdicts  # noqa: F401 — the fixture
from test_torch_cluster_cases import cases, check_case

REFERENCE_FILES = ("test_checkpoint", "test_local_recovery",
                   "test_incremental_changelog", "test_savepoint_compat",
                   "test_incremental_checkpoints")


@pytest.mark.parametrize("ref, cls, fn_name, params",
                         cases(REFERENCE_FILES))
def test_reference_case(ref, cls, fn_name, params, tmp_path_factory,
                        verdicts):  # noqa: F811 — the fixture
    check_case(ref, cls, fn_name, params, tmp_path_factory, verdicts)

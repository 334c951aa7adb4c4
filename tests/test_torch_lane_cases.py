"""Port parity for the window operator's lanes and the device libraries:
every case of the reference's ``tests/test_native_mirror.py``,
``test_device_sync.py``, ``test_pipeline_equivalence.py``,
``test_mesh_runtime.py``, ``test_mesh_invariance.py``,
``test_cep_vectorized.py`` and ``test_graph_lib.py``, run through both
packages with the harness of ``tests/test_torch_cluster_cases.py`` (each
keeping its reference marks), apart from the cases ``HAND_COUNTERPART``
names with the port tests that hold them, and the two 256k-key paging
acceptances, which ``OWN_COUNTERPART`` leaves to
``tests/test_torch_pipeline.py`` and ``tests/test_torch_mesh.py``.

Every verdict is pinned (``verdicts``, probe off), so JAX's runs never
resolve ``device_probe="auto"``, which imports ``jax.experimental.
enable_x64`` (ROADMAP Queue C item 4).  A JAX mesh's sharded leaf is one
array whose ``.sharding.device_set`` holds the mesh's devices; the port's
is a list of row blocks, one on each mesh position's device, so the port's
run of ``test_mesh_runtime.py`` counts the blocks (:data:`BLOCKS`).
"""

import pytest

from test_torch_calibration import verdicts  # noqa: F401 — the fixture
from test_torch_cluster_cases import cases, check_case

REFERENCE_FILES = ("test_native_mirror", "test_device_sync",
                   "test_pipeline_equivalence", "test_mesh_runtime",
                   "test_mesh_invariance", "test_cep_vectorized",
                   "test_graph_lib")

#: the port's run of ``test_mesh_runtime.py``: a sharded leaf's devices are
#: its blocks'
BLOCKS = (("len(op._leaves[0].sharding.device_set)", "len(op._leaves[0])"),
          ("len(op2._leaves[0].sharding.device_set)", "len(op2._leaves[0])"))


@pytest.mark.parametrize("ref, cls, fn_name, params",
                         cases(REFERENCE_FILES, marks=True))
def test_reference_case(ref, cls, fn_name, params, tmp_path_factory,
                        verdicts):  # noqa: F811 — the fixture
    check_case(ref, cls, fn_name, params, tmp_path_factory, verdicts,
               port_patches=BLOCKS if ref == "test_mesh_runtime" else ())

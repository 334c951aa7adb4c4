"""Port parity for the core primitives and the keyed-state layer: every
case of the reference's ``tests/test_keygroups.py``, ``test_batch.py``,
``test_keyindex.py``, ``test_native.py``, ``test_config.py``,
``test_memory_manager.py``, ``test_shuffle.py``, ``test_parallel.py``,
``test_state.py``, ``test_spill_state.py`` and ``test_evolution.py``, run
through both packages with the harness of
``tests/test_torch_cluster_cases.py`` (each keeping its reference marks).

``test_native.py`` imports the JAX package's ``native/fallback.py``, the
zlib stand-in the port has no counterpart of (its native layer raises when
a source does not build): the port's run drops that import, and the two
cases that compare the stand-in with the C codec are
:data:`FALLBACK_CASES`.  ``test_parallel.py``'s two cases that read a JAX
mesh's ``devices`` array and an array's ``.sharding`` are in
``HAND_COUNTERPART``, with the port tests that hold them.
"""

import pytest

from test_torch_calibration import verdicts  # noqa: F401 — the fixture
from test_torch_cluster_cases import cases, check_case

REFERENCE_FILES = ("test_keygroups", "test_batch", "test_keyindex",
                   "test_native", "test_config", "test_memory_manager",
                   "test_shuffle", "test_parallel", "test_state",
                   "test_spill_state", "test_evolution")

#: ``test_native.py``'s cases of the Python stand-in
#: (``flink_tpu/native/fallback.py``), which has no counterpart in the port
FALLBACK_CASES = {"test_native::test_delta_varint_fallback_parity",
                  "test_native::test_delta_varint_fallback_extreme_delta"}

#: the port's run of ``test_native.py`` imports no stand-in
NO_FALLBACK_IMPORT = (("from flink_tpu.native import codec, fallback",
                       "from flink_tpu.native import codec"),)


def _cases():
    return [p for p in cases(REFERENCE_FILES, marks=True)
            if p.id not in FALLBACK_CASES]


@pytest.mark.parametrize("ref, cls, fn_name, params", _cases())
def test_reference_case(ref, cls, fn_name, params, tmp_path_factory,
                        verdicts):  # noqa: F811 — the fixture
    check_case(ref, cls, fn_name, params, tmp_path_factory, verdicts,
               port_patches=NO_FALLBACK_IMPORT if ref == "test_native"
               else ())

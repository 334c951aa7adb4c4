"""Port parity for the distributed runtime's chaos: the reference's cases
of ``tests/test_nemesis.py`` (network partitions through the TCP-level
``FreezableProxy`` against the object-store lease election) and
``tests/test_clock_chaos.py`` (seeded ``ClockSkew`` through every clock
decision), run through both packages with the harness of
``tests/test_torch_cluster_cases.py``, each keeping its reference marks.
"""

import pytest

import flink_tpu_torch.cluster.distributed  # noqa: F401 — patched by the harness
from test_torch_calibration import verdicts  # noqa: F401 — the fixture
from test_torch_cluster_cases import cases, check_case


@pytest.mark.parametrize("ref, cls, fn_name, params",
                         cases(("test_nemesis", "test_clock_chaos"),
                               marks=True))
def test_reference_case(ref, cls, fn_name, params, tmp_path_factory,
                        verdicts):  # noqa: F811 — the fixture
    check_case(ref, cls, fn_name, params, tmp_path_factory, verdicts)


@pytest.mark.chaos
def test_clock_skew_is_the_same_schedule_in_both_packages():
    """One seed, one ``ClockSkew``: both packages' injectors hand the clock
    seam the same offsets, reading for reading (jumps, drift, seeded
    jitter, the recovered tail after ``times``)."""
    from flink_tpu.testing import chaos as jax_chaos
    from flink_tpu_torch.testing import chaos as port_chaos
    seen = []
    for chaos in (jax_chaos, port_chaos):
        inj = chaos.FaultInjector(seed=11)
        inj.inject("clock.wall", chaos.ClockSkew(
            jumps=[(3, -250.0), (9, 40.0)], drift_ms_per_read=0.5,
            jitter_ms=2.0, times=14))
        with chaos.installed(inj):
            seen.append([chaos.skew("clock.wall") for _ in range(20)])
    assert [x.hex() for x in seen[0]] == [x.hex() for x in seen[1]]
    assert seen[0][-1] == 0.0

"""Port parity for the early operators: every case of the reference's
``tests/test_window_agg.py``, ``test_count_window_slide.py``,
``test_session_windows.py``, ``test_evicting_device.py``, ``test_cep.py``
and ``test_process.py``, run through both packages with the harness of
``tests/test_torch_cluster_cases.py`` (each keeping its reference marks),
and the counterpart of the one case it cannot compare call by call.

``test_session_windows.py`` asks for ``SumAggregator(jnp.float64)``, which
JAX (x64 off) folds in f32 and the port in f64: the port's run of that file
pins JAX's resolution (``_acc_dtypes_as_jax``).
"""

import numpy as np
import pytest

from test_torch_calibration import verdicts  # noqa: F401 — the fixture
from test_torch_cluster_cases import (_acc_dtypes_as_jax, _run, cases,
                                      check_case)

REFERENCE_FILES = ("test_window_agg", "test_count_window_slide",
                   "test_session_windows", "test_evicting_device",
                   "test_cep", "test_process")

#: the files whose port run pins JAX's accumulator dtypes
ACC_DTYPES_AS_JAX = ("test_session_windows",)


@pytest.mark.parametrize("ref, cls, fn_name, params",
                         cases(REFERENCE_FILES, marks=True))
def test_reference_case(ref, cls, fn_name, params, tmp_path_factory,
                        verdicts):  # noqa: F811 — the fixture
    check_case(ref, cls, fn_name, params, tmp_path_factory, verdicts,
               port_pins=(_acc_dtypes_as_jax,) if ref in ACC_DTYPES_AS_JAX
               else ())


# ---------------------------------------------------------------------------
# the counterpart of OWN_COUNTERPART's test_window_agg case
# ---------------------------------------------------------------------------

def _async_rows(pkg, async_fire):
    """``test_async_fire_same_results_one_call_later``'s run, on one
    package: (the rows of each call, the final rows by key and window)."""
    import importlib
    batch = importlib.import_module(f"{pkg}.core.batch")
    fns = importlib.import_module(f"{pkg}.core.functions")
    wa = importlib.import_module(f"{pkg}.operators.window_agg")
    asg = importlib.import_module(f"{pkg}.windowing.assigners")
    if pkg == "flink_tpu_torch":
        import torch
        f32, kw = torch.float32, {"device": "cpu"}
    else:
        import jax.numpy as jnp
        f32, kw = jnp.float32, {}
    rng = np.random.default_rng(21)
    n = 5000
    keys = rng.integers(0, 37, n)
    vals = rng.random(n).astype(np.float32)
    ts = np.sort(rng.integers(0, 5000, n))
    op = wa.WindowAggOperator(asg.TumblingEventTimeWindows.of(1000),
                              fns.SumAggregator(f32), key_column="k",
                              value_column="v", async_fire=async_fire, **kw)
    op.open(fns.RuntimeContext())
    calls, rows = [], {}
    for lo in range(0, n, 512):
        hi = min(lo + 512, n)
        calls.append(op.process_batch(batch.RecordBatch(
            {"k": keys[lo:hi], "v": vals[lo:hi]}, timestamps=ts[lo:hi])))
        calls.append(op.process_watermark(batch.Watermark(int(ts[hi - 1])
                                                          - 1)))
    calls.append(op.end_input())
    per_call = []
    for out in calls:
        got = []
        for b in out:
            for r in b.to_rows():
                rows[(r["k"], r["window_start"])] = r["result"]
                got.append((r["k"], r["window_start"],
                            np.float32(r["result"]).tobytes()))
        per_call.append(sorted(got))
    return per_call, rows


def test_async_fire_same_results_one_call_later_on_both_packages(
        tmp_path_factory, verdicts):  # noqa: F811 — the fixture
    """``test_window_agg.py::test_async_fire_same_results_one_call_later``
    on both packages.  JAX's async CPU dispatch can surface an async fire
    one call later than the port does (ROADMAP Queue C item 7), so the
    harness's call-by-call record cannot compare it.  Here the case as
    written passes on the port; each package's async rows equal its sync
    rows; the port's sync fires equal JAX's call by call, bit for bit; and
    the async rows of the two packages are the same set, bit for bit."""
    verdicts(taxed=False, shards=1, super_shards=1, depth=1, probe=False)
    record = _run("test_window_agg", None,
                  "test_async_fire_same_results_one_call_later", {}, "port",
                  tmp_path_factory)
    assert not [r for r in record if r[0] == "case raises"], record[-1:]
    got = {}
    for pkg in ("flink_tpu", "flink_tpu_torch"):
        sync_calls, sync_rows = _async_rows(pkg, False)
        async_calls, async_rows = _async_rows(pkg, True)
        assert sync_rows == async_rows and sync_rows
        got[pkg] = (sync_calls, sorted(r for c in async_calls for r in c))
    assert got["flink_tpu_torch"] == got["flink_tpu"]

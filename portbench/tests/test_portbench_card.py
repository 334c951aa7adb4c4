"""Each cell end to end on the card, briefly: the command as the checks run
it, its result line, and ``correct``.  Needs a CUDA card; skips elsewhere.

    python -m pytest portbench/tests/test_portbench_card.py -q -m cuda
"""

import json
import subprocess
import sys

import pytest

from portbench.lib import harness

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in
         harness.load_json(harness.REPO / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(cuda_device, name, trace):
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name,
         "--seed", str(2 ** 31 + 99), "--seconds", "3", "--trace",
         str(trace)], cwd=harness.REPO, capture_output=True, text=True,
        timeout=1200)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    cell = harness.load_cell(name)
    want = ([m["name"] for m in cell.per_layer] if trace
            else list(cell.end_to_end))
    assert set(out["metrics"]) == set(want)
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert len(out["breakdown"]["device_ops"]) <= 10

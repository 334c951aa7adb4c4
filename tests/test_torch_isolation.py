"""The port stands alone: ``flink_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package, and the port's entry points
never fall back to the CPU on their own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "flink_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_and_no_jax_package_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "flink_tpu")]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    """Import every port module (and chip_smoke) in a fresh interpreter
    where ``jax`` and ``flink_tpu`` cannot be imported at all."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flink_tpu'] = None\n"
        "import flink_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "flink_tpu_torch.__path__, 'flink_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules"
        " if sys.modules[m] is not None]\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 13


def test_window_operator_default_device_raises_without_cuda(monkeypatch):
    from flink_tpu_torch.core.functions import SumAggregator
    from flink_tpu_torch.operators.window_agg import WindowAggOperator
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WindowAggOperator(TumblingEventTimeWindows.of(100), SumAggregator(),
                          key_column="k", value_column="v")


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Alone in a directory, or with no card, the smoke exits nonzero and
    prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd, script in ((tmp_path, lone), (REPO, REPO / "chip_smoke.py")):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert res.returncode != 0
        assert '"ok"' not in res.stdout

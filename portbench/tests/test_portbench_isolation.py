"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``flink_tpu_torch`` begins with ``flink_tpu``), the
plain references import nothing of the program, and a run refuses where
it cannot measure the card."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.lib import harness

BENCH = harness.REPO / "portbench"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path: Path):
    """Top-level names of every module ``path`` imports, and the modules
    named in its ``import`` statements whole."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    for name in _imports(path):
        assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    for name in _imports(path):
        assert name.split(".")[0] in ("__future__", "numpy", "torch"), \
            (path, name)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "flink_tpu_torch_fake", object())
    assert harness.forbidden_modules() == [
        m for m in harness.forbidden_modules() if m != "flink_tpu_torch_fake"]
    monkeypatch.setitem(sys.modules, "flink_tpu.state.fake", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    found = harness.forbidden_modules()
    assert "flink_tpu.state.fake" in found and "jaxlib" in found
    assert "flink_tpu_torch_fake" not in found


def _run(cwd: Path):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "tumble_sum_1m.uniform", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_a_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    res = _run(harness.REPO)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_a_run_without_the_program_prints_no_result(tmp_path):
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""

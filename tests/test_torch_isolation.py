"""The port stands alone: ``flink_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package, its C host layer builds from
its own source with its own symbol names, and the port's entry points
never fall back to the CPU on their own."""

import ast
import os
import shutil
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
        "assert 'flink_tpu_torch.operators.fused_step' in names\n"
        "import chip_smoke\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules"
        " if sys.modules[m] is not None]\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 14


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


def test_host_library_builds_from_its_own_source(monkeypatch, tmp_path):
    """The port's C host layer compiles from ``csrc/host_mirror.cc`` alone:
    the loader reads no file under ``native/`` or ``flink_tpu/`` (recorded
    through the build's ``open`` and the compiler's command line), and its
    source names none."""
    from flink_tpu_torch.kernels import build
    assert build.HOST_SOURCE == "host_mirror.cc"
    src = Path(build.CSRC_DIR) / build.HOST_SOURCE
    assert src.is_file() and src.parent == PORT / "csrc"
    loader = (PORT / "kernels" / "build.py").read_text()
    for bad in ("native/", "flink_tpu/", "flink_native"):
        assert bad not in loader
    assert "#include \"" not in src.read_text()   # no header of the repo
    read, cmds = [], []
    real_open = open
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setitem(build.__dict__, "open", lambda p, *a, **k: (
        read.append(os.path.realpath(p)), real_open(p, *a, **k))[1])
    real_run = build.subprocess.run
    monkeypatch.setattr(build.subprocess, "run", lambda cmd, *a, **k: (
        cmds.append(list(cmd)), real_run(cmd, *a, **k))[1])
    lib = build.host_mirror_lib()
    assert read == [str(src.resolve())]
    (cmd,) = cmds
    assert [c for c in cmd if c.endswith((".cc", ".cpp", ".h"))] == [str(src)]
    assert not [c for c in cmd if "native" in c or "flink_tpu/" in c]
    assert int(lib.ftt_keydict_size(lib.ftt_keydict_create(16))) == 0


def test_host_library_exports_only_prefixed_symbols():
    """Every entry point of ``csrc/host_mirror.cc`` carries the port's
    ``ftt_`` prefix, in the source and in the built library's dynamic
    symbols (std template code aside, which the linker merges as weak)."""
    import re

    from flink_tpu_torch.kernels import build
    text = (PORT / "csrc" / "host_mirror.cc").read_text()
    names = re.findall(r"^API\s+[\w\s\*]+?\b(\w+)\s*\(", text, re.M)
    assert len(names) >= 19
    assert all(n.startswith("ftt_") for n in names), names
    nm = shutil.which("nm")
    if nm is None:
        pytest.skip("nm is not installed")
    res = subprocess.run([nm, "-D", "--defined-only",
                          build.build_host(build.HOST_SOURCE)],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    strong = [line.split()[-1] for line in res.stdout.splitlines()
              if line.split()[-2] in ("T", "D", "B", "R")]
    assert set(strong) == set(names)


@pytest.mark.parametrize("src", sorted(
    p.name for p in (PORT / "csrc").iterdir()
    if p.suffix in (".cu", ".cuh")))
def test_cuda_sources_include_only_the_port_and_the_toolkit(src):
    """Every CUDA source builds from the port's ``csrc/`` alone: a quoted
    include names a file there (``ordered_fold.cuh``, ``probe_walk.cuh``),
    an angled one a header of the CUDA toolkit (CUB among them)."""
    import re
    text = (PORT / "csrc" / src).read_text()
    quoted = re.findall(r'^#include\s+"([^"]+)"', text, re.M)
    angled = re.findall(r"^#include\s+<([^>]+)>", text, re.M)
    assert all("/" not in q and (PORT / "csrc" / q).is_file()
               for q in quoted), quoted
    assert all(a.split("/")[0] in ("cuda_runtime.h", "stdint.h", "cub")
               for a in angled), angled


def test_the_ordered_fold_is_shared():
    """``probe_fold.cu`` and ``scatter_fold.cu`` take steps 2-4 from the
    one header, and neither defines them itself."""
    import re
    steps = re.compile(r"__global__[^;{]*?\b(tile_scan_kernel|scatter_kernel"
                       r"|fold_kernel)\(", re.S)
    csrc = PORT / "csrc"
    for src in ("probe_fold.cu", "scatter_fold.cu"):
        text = (csrc / src).read_text()
        assert '#include "ordered_fold.cuh"' in text
        assert not steps.findall(text), src
    assert sorted(steps.findall((csrc / "ordered_fold.cuh").read_text())) \
        == ["fold_kernel", "scatter_kernel", "tile_scan_kernel"]

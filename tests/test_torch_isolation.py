"""The port stands alone: ``flink_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package, nor pandas (the card's machine
has none), its C host layer builds from its own source with its own symbol
names, and the port's entry points never fall back to the CPU on their
own."""

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


def test_no_port_module_imports_pandas():
    bad = [str(p.relative_to(REPO)) for p in SOURCES
           if any(m.split(".")[0] == "pandas"
                  for m in _imported_modules(p))]
    assert not bad, f"{bad} import pandas"


def test_every_module_imports_with_jax_blocked():
    """Import every port module (and chip_smoke) in a fresh interpreter
    where ``jax``, ``flink_tpu`` and ``pandas`` cannot be imported at
    all."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flink_tpu'] = None\n"
        "sys.modules['pandas'] = None\n"
        "import flink_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "flink_tpu_torch.__path__, 'flink_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert 'flink_tpu_torch.operators.fused_step' in names\n"
        "assert 'flink_tpu_torch.utils.transport' in names\n"
        "assert 'flink_tpu_torch.runtime.device_health' in names\n"
        "assert 'flink_tpu_torch.testing.chaos' in names\n"
        "for n in ('operators.session_window', 'operators.evicting_device',"
        " 'windowing.evictors', 'parallel.mesh_runtime', 'cep',"
        " 'cep.pattern', 'cep.operator', 'cep.vectorized',"
        " 'ops.join_kernels', 'operators.joins', 'operators.sql_ops',"
        " 'graph_lib', 'graph_lib.graph', 'state.api', 'state.evolution',"
        " 'state.heap', 'state.changelog', 'runtime.timers',"
        " 'operators.process', 'config.config_option', 'config.options',"
        " 'utils.clock', 'core.types', 'connectors.sources',"
        " 'connectors.sinks', 'operators.chain', 'graph.transformations',"
        " 'graph.stream_graph', 'runtime.memory', 'metrics', 'metrics.core',"
        " 'metrics.groups', 'runtime.executor', 'datastream',"
        " 'datastream.api', 'windowing', 'state', 'state.spill',"
        " 'operators.co', 'operators.async_io', 'operators.iteration',"
        " 'operators.evicting_window', 'testing', 'testing.harness',"
        " 'native', 'native.codec', 'formats', 'connectors.util',"
        " 'runtime.checkpoint', 'runtime.checkpoint.storage',"
        " 'runtime.shuffle', 'dataset', 'dataset.api', 'dataset.external',"
        " 'dataset.optimizer', 'state_processor',"
        " 'state_processor.savepoint', 'runtime.checkpoint.delta',"
        " 'runtime.checkpoint.incremental', 'runtime.checkpoint.local',"
        " 'runtime.checkpoint.failure', 'runtime.checkpoint.objectstore',"
        " 'observability', 'observability.tracing',"
        " 'observability.latency', 'observability.assembly',"
        " 'connectors.enumerator', 'cluster', 'cluster.channels',"
        " 'cluster.task', 'cluster.failover', 'cluster.rpc',"
        " 'cluster.heartbeat', 'cluster.minicluster', 'cluster.adaptive',"
        " 'filesystems'):\n"
        "    assert 'flink_tpu_torch.' + n in names, n\n"
        "import chip_smoke\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules"
        " if sys.modules[m] is not None]\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 14


def test_canonical_flow_runs_with_jax_and_pandas_blocked():
    """The verify skill's canonical flow (string keys) as a
    ``flink_tpu_torch`` job on ``LocalExecutor``, in a fresh interpreter
    where ``jax``, ``flink_tpu`` and ``pandas`` cannot be imported."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flink_tpu', 'pandas'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from flink_tpu_torch.core.functions import SumAggregator\n"
        "from flink_tpu_torch.datastream import StreamExecutionEnvironment\n"
        "from flink_tpu_torch.windowing import TumblingEventTimeWindows\n"
        "env = StreamExecutionEnvironment.get_execution_environment("
        "device='cpu')\n"
        "rows = [{'k': k, 'v': 1.0, 'ts': t} for t in range(0, 1000, 10)"
        " for k in ('a', 'b')]\n"
        "res = (env.from_collection(rows, timestamp_column='ts')"
        ".assign_timestamps_and_watermarks(0, timestamp_column='ts')"
        ".key_by('k').window(TumblingEventTimeWindows.of(100))"
        ".aggregate(SumAggregator(torch.float32), value_column='v')"
        ".execute_and_collect())\n"
        "assert len(res) == 20 and {r['result'] for r in res} == {10.0}\n"
        "assert sorted({r['k'] for r in res}) == ['a', 'b']\n"
        "print('rows', len(res))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["rows", "20"]


def test_batch_side_runs_with_jax_and_pandas_blocked():
    """A DataSet plan through the batch side (an out-of-core sort and
    grace join over the port's FTB spill files, a hash exchange through
    the sort-merge shuffle, a savepoint bootstrapped, stored and read
    back) in a fresh interpreter where ``jax``, ``flink_tpu`` and
    ``pandas`` cannot be imported."""
    code = (
        "import os, sys, tempfile\n"
        "for m in ('jax', 'flink_tpu', 'pandas'):\n"
        "    sys.modules[m] = None\n"
        "os.environ['FLINK_TPU_BATCH_MEMORY_ROWS'] = '500'\n"
        "import numpy as np\n"
        "from flink_tpu_torch.dataset import ExecutionEnvironment\n"
        "from flink_tpu_torch.dataset import external\n"
        "from flink_tpu_torch.runtime.checkpoint import "
        "FileCheckpointStorage\n"
        "from flink_tpu_torch.state_processor import Savepoint, "
        "SavepointWriter\n"
        "env = ExecutionEnvironment(device='cpu')\n"
        "a = env.from_columns({'k': np.arange(3000) % 700, "
        "'v': np.arange(3000.0)})\n"
        "b = env.from_columns({'k': np.arange(700), 'w': np.ones(700)})\n"
        "j = a.join(b).where('k').equal_to('k').apply()\n"
        "assert len(j.sort_partition('v').collect()) == 3000\n"
        "assert sum(len(x) for x in a.partition_by_hash('k')"
        ".map_partition(lambda p: p).stream_batches()) == 3000\n"
        "assert external.spilled_bytes['join'] > 0\n"
        "d = tempfile.mkdtemp()\n"
        "SavepointWriter.new_savepoint().with_keyed_state("
        "'op', b, 'k', 'w', 's').write(FileCheckpointStorage(d))\n"
        "rows = Savepoint.load(FileCheckpointStorage(d), device='cpu')"
        ".read_keyed_state('op', 's').collect()\n"
        "print('rows', len(rows))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["rows", "700"]


def test_batch_side_defaults_to_the_card(monkeypatch):
    """The DataSet environment's device and the savepoint reader's are the
    card by default: the join's device lane raises without CUDA rather
    than fall back to the CPU."""
    import numpy as np

    from flink_tpu_torch.dataset import ExecutionEnvironment
    from flink_tpu_torch.state_processor import Savepoint, SavepointWriter
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("FLINK_TPU_DEVICE_JOIN", "1")
    ds = ExecutionEnvironment().from_columns({"k": np.arange(3)})
    seed = ExecutionEnvironment(device="cpu").from_columns(
        {"k": np.arange(3), "x": np.ones(3)})
    snap = SavepointWriter.new_savepoint().with_keyed_state(
        "op", seed, "k", "x", "s").snapshot
    read = Savepoint.from_snapshot(snap).read_keyed_state("op", "s")
    for d in (ds, read):
        assert d.env.device is None
        with pytest.raises(RuntimeError, match="device='cpu'"):
            d.join(d).where(*d.collect_batch().columns).equal_to(
                *d.collect_batch().columns).apply().collect()


def test_codec_library_builds_from_its_own_source(monkeypatch, tmp_path):
    """The batch codec compiles from ``csrc/codec.cc`` alone (no file of
    ``native/`` or ``flink_tpu/``, system headers only), and every entry
    point of it, in the source and in the built library, carries the
    ``ftt_`` prefix."""
    import re

    from flink_tpu_torch.kernels import build
    src = Path(build.CSRC_DIR) / build.CODEC_SOURCE
    text = src.read_text()
    assert re.findall(r'^#include\s+"', text, re.M) == []
    names = re.findall(r"^API\s+[\w\s\*]+?\b(\w+)\s*\(", text, re.M)
    assert sorted(names) == sorted(
        f"ftt_{n}" for n in ("delta_varint_encode_i64",
                             "delta_varint_decode_i64", "lz_bound",
                             "lz_compress", "lz_decompress", "crc32",
                             "crc32c"))
    read, cmds = [], []
    real_open = open
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setitem(build.__dict__, "open", lambda p, *a, **k: (
        read.append(os.path.realpath(p)), real_open(p, *a, **k))[1])
    real_run = build.subprocess.run
    monkeypatch.setattr(build.subprocess, "run", lambda cmd, *a, **k: (
        cmds.append(list(cmd)), real_run(cmd, *a, **k))[1])
    lib = build.codec_lib()
    assert read == [str(src.resolve())]
    (cmd,) = cmds
    assert [c for c in cmd if c.endswith((".cc", ".cpp", ".h"))] == [str(src)]
    assert not [c for c in cmd if "native" in c or "flink_tpu/" in c]
    assert int(lib.ftt_lz_bound(255)) == 255 + 1 + 80
    nm = shutil.which("nm")
    if nm is None:
        return
    res = subprocess.run([nm, "-D", "--defined-only",
                          build.library_path(build.CODEC_SOURCE)],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    strong = [line.split()[-1] for line in res.stdout.splitlines()
              if line.split()[-2] in ("T", "D", "B", "R")]
    assert set(strong) == set(names)


def test_window_operator_default_device_raises_without_cuda(monkeypatch):
    from flink_tpu_torch.core.functions import SumAggregator
    from flink_tpu_torch.operators.window_agg import WindowAggOperator
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WindowAggOperator(TumblingEventTimeWindows.of(100), SumAggregator(),
                          key_column="k", value_column="v")


def test_session_and_evicting_operators_default_to_the_card(monkeypatch):
    """The evicting lane's default device is the card, and so is the mesh
    session operator's default mesh: both raise without CUDA.  The host
    session operator needs no device."""
    from flink_tpu_torch.core.functions import SumAggregator
    from flink_tpu_torch.operators.evicting_device import \
        DeviceEvictingWindowOperator
    from flink_tpu_torch.operators.session_window import \
        SessionWindowOperator
    from flink_tpu_torch.parallel.mesh_runtime import \
        MeshSessionWindowOperator
    from flink_tpu_torch.windowing.assigners import (EventTimeSessionWindows,
                                                     TumblingEventTimeWindows)
    from flink_tpu_torch.windowing.evictors import CountEvictor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceEvictingWindowOperator(
            TumblingEventTimeWindows.of(100), CountEvictor.of(2),
            SumAggregator(), key_column="k", value_column="v")
    with pytest.raises(RuntimeError, match="CUDA devices"):
        MeshSessionWindowOperator(EventTimeSessionWindows(10),
                                  SumAggregator(), key_column="k",
                                  value_column="v", n_devices=4)
    SessionWindowOperator(EventTimeSessionWindows(10), SumAggregator(),
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
    """``probe_fold.cu`` takes steps 2-4 from the one header and defines none
    of them itself; ``scatter_fold.cu``, redesigned for rows rather than
    tiles, defines its own two steps and leaves the header, and with it
    ``probe_fold``'s steps, alone."""
    import re
    steps = re.compile(r"__global__[^;{]*?\b(\w+_kernel)\(", re.S)
    csrc = PORT / "csrc"
    probe_fold = (csrc / "probe_fold.cu").read_text()
    assert '#include "ordered_fold.cuh"' in probe_fold
    assert steps.findall(probe_fold) == ["probe_hist_kernel"]
    scatter_fold = (csrc / "scatter_fold.cu").read_text()
    assert '#include "ordered_fold.cuh"' not in scatter_fold
    assert sorted(steps.findall(scatter_fold)) == ["fold_kernel",
                                                   "partition_kernel"]
    assert sorted(steps.findall((csrc / "ordered_fold.cuh").read_text())) \
        == ["fold_kernel", "scatter_kernel", "tile_scan_kernel"]


def test_spill_library_builds_from_its_own_source(monkeypatch, tmp_path):
    """The paging tier's spill store compiles from ``csrc/spill_store.cc``
    alone: the loader reads no other file, the compiler's command line names
    no file of ``native/`` or ``flink_tpu/``, and the source includes only
    system headers."""
    import re

    from flink_tpu_torch.kernels import build
    src = Path(build.CSRC_DIR) / build.SPILL_SOURCE
    assert src.is_file() and src.parent == PORT / "csrc"
    text = src.read_text()
    assert re.findall(r'^#include\s+"', text, re.M) == []
    read, cmds = [], []
    real_open = open
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setitem(build.__dict__, "open", lambda p, *a, **k: (
        read.append(os.path.realpath(p)), real_open(p, *a, **k))[1])
    real_run = build.subprocess.run
    monkeypatch.setattr(build.subprocess, "run", lambda cmd, *a, **k: (
        cmds.append(list(cmd)), real_run(cmd, *a, **k))[1])
    lib = build.spill_store_lib()
    assert read == [str(src.resolve())]
    (cmd,) = cmds
    assert [c for c in cmd if c.endswith((".cc", ".cpp", ".h"))] == [str(src)]
    assert not [c for c in cmd if "native" in c or "flink_tpu/" in c]
    h = lib.ftt_spill_open(str(tmp_path / "store").encode(), 1024, 13)
    assert h and int(lib.ftt_spill_count(h)) == 0
    lib.ftt_spill_close(h)


def test_spill_library_exports_only_prefixed_symbols():
    """Every entry point of ``csrc/spill_store.cc`` carries the ``ftt_``
    prefix, in the source and in the built library's dynamic symbols."""
    import re

    from flink_tpu_torch.kernels import build
    text = (PORT / "csrc" / build.SPILL_SOURCE).read_text()
    names = re.findall(r"^API\s+[\w\s\*]+?\b(\w+)\s*\(", text, re.M)
    # 9 entries of the paging tier's cell store, 14 of the key-value store
    assert len(names) == 23
    assert sum(n.startswith("ftt_spill_kv_") for n in names) == 14
    assert all(n.startswith("ftt_spill_") for n in names), names
    nm = shutil.which("nm")
    if nm is None:
        pytest.skip("nm is not installed")
    res = subprocess.run([nm, "-D", "--defined-only",
                          build.build_host(build.SPILL_SOURCE)],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    strong = [line.split()[-1] for line in res.stdout.splitlines()
              if line.split()[-2] in ("T", "D", "B", "R")]
    assert set(strong) == set(names)


def test_checkpointed_minicluster_job_runs_with_jax_and_pandas_blocked():
    """A windowed job on the MiniCluster (two window subtasks, incremental
    checkpoints into ``IncrementalCheckpointStorage``, each subtask step
    slowed by 2 ms so checkpoints complete while it runs) in a fresh
    interpreter where ``jax``, ``flink_tpu`` and ``pandas`` cannot be
    imported; exactly-once sums, and the stored chain resolves."""
    code = (
        "import sys, tempfile\n"
        "for m in ('jax', 'flink_tpu', 'pandas'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "from flink_tpu_torch.core.functions import SumAggregator\n"
        "from flink_tpu_torch.datastream import StreamExecutionEnvironment\n"
        "from flink_tpu_torch.runtime.checkpoint.incremental import "
        "IncrementalCheckpointStorage\n"
        "from flink_tpu_torch.testing import chaos\n"
        "from flink_tpu_torch.windowing import TumblingEventTimeWindows\n"
        "rng = np.random.default_rng(3)\n"
        "n = 20000\n"
        "cols = {'k': rng.integers(0, 300, n), 'v': np.ones(n, np.float32),"
        " 't': np.sort(rng.integers(0, 8000, n))}\n"
        "env = StreamExecutionEnvironment(device='cpu')\n"
        "env.set_parallelism(2)\n"
        "sink = (env.from_collection(columns=cols, batch_size=250)"
        ".assign_timestamps_and_watermarks(0, timestamp_column='t')"
        ".key_by('k').window(TumblingEventTimeWindows.of(1000))"
        ".aggregate(SumAggregator(torch.float32), value_column='v')"
        ".collect())\n"
        "inj = chaos.FaultInjector(seed=1)\n"
        "inj.inject('subtask.run', chaos.DelayBy(0.002))\n"
        "st = IncrementalCheckpointStorage(tempfile.mkdtemp())\n"
        "with chaos.installed(inj):\n"
        "    res = env.execute_cluster(storage=st, incremental=True,"
        " checkpoint_interval_ms=10, timeout_s=60)\n"
        "assert res.state == 'FINISHED', res\n"
        "final = {}\n"
        "for r in sink.rows():\n"
        "    final[(r['k'], r['window_start'])] = r['result']\n"
        "assert sum(final.values()) == n\n"
        "assert res.completed_checkpoints and st.load_latest() is not None\n"
        "print('checkpoints', len(res.completed_checkpoints) > 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["checkpoints", "True"]

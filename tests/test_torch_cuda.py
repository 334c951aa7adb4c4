"""The port on the card: the probe kernel against its plain version, and the
window operator on CUDA against the same operator on the CPU.

These tests need an NVIDIA GPU and nvcc (the kernel has no CPU mode); they
skip with a reason elsewhere.  This file imports nothing of JAX, so it runs
on a machine that has only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
"""

import numpy as np
import pytest
import torch

from flink_tpu_torch.core.batch import RecordBatch, Watermark
from flink_tpu_torch.core.functions import SumAggregator
from flink_tpu_torch.operators.window_agg import WindowAggOperator
from flink_tpu_torch.state import device_keyindex as dk
from flink_tpu_torch.state.keyindex import KeyIndex
from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the probe kernel has no CPU mode")
    return torch.device("cuda")


def test_probe_kernel_equals_torch_probe(cuda_device):
    rng = np.random.default_rng(1234)
    keys = rng.integers(-2 ** 62, 2 ** 62, 20000).astype(np.int64)
    ki = KeyIndex()
    ki.lookup_or_insert(keys)
    dki = dk.DeviceKeyIndex(initial_capacity=1 << 10, device=cuda_device)
    dki.ensure_loaded(ki)
    batch = np.concatenate([keys, rng.integers(2 ** 62, 2 ** 63 - 1, 3000)])
    planes = [torch.from_numpy(a).to(cuda_device)
              for a in dki.prepare_batch(batch)]
    before = dk.probe.launches
    got = dk.probe(*dki.table(), *planes)
    torch.cuda.synchronize()
    assert dk.probe.launches == before + 1
    assert torch.equal(got, dk.torch_probe(*dki.table(), *planes))
    assert np.array_equal(got.cpu().numpy(), ki.lookup(batch))


def _run(device):
    rng = np.random.default_rng(11)
    op = WindowAggOperator(TumblingEventTimeWindows.of(100), SumAggregator(),
                           key_column="k", value_column="v", device=device)
    out = []
    for i in range(10):
        keys = rng.integers(0, 1500, 4000).astype(np.int64)
        vals = rng.random(4000).astype(np.float32)
        ts = i * 50 + np.sort(rng.integers(0, 50, 4000)).astype(np.int64)
        out += op.process_batch(RecordBatch({"k": keys, "v": vals},
                                            timestamps=ts))
        out += op.process_watermark(Watermark(int(ts.max()) - 1))
    out += op.end_input()
    assert op.verify_mirror()
    return out, op.device_probe_stats()


def test_operator_on_the_card_fires_like_the_cpu(cuda_device):
    """Same stream, same fires: slot ids agree (one numpy KeyIndex on both
    sides), values to rtol 1e-6 (f64 atomics fold in no fixed order)."""
    before = dk.probe.launches
    gpu, gstats = _run(cuda_device)
    assert dk.probe.launches - before == 10
    cpu, cstats = _run("cpu")
    assert gstats == cstats
    assert len(gpu) == len(cpu)
    for g, c in zip(gpu, cpu):
        assert int(g.column("window_start")[0]) == \
            int(c.column("window_start")[0])
        assert np.array_equal(g.column("k"), c.column("k"))
        np.testing.assert_allclose(g.column("result"), c.column("result"),
                                   rtol=1e-6, atol=1e-6)

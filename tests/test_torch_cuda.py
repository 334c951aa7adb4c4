"""The port on the card: the probe and probe_fold kernels against their
plain versions, and the window operator on CUDA against the same operator on
the CPU.

These tests need an NVIDIA GPU and nvcc (the kernels have no CPU mode); they
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
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
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


@pytest.mark.parametrize("value_kind", ["float", "int"])
def test_probe_fold_kernel_equals_torch_probe_fold(cuda_device, value_kind):
    """The fused kernel on the card against the plain version on CPU copies
    of the same tensors: ``slot``, ``dcnt`` and ``dsum`` bit for bit (the
    fold keeps row order per cell), with unseen keys, one hot cell and rows
    past ``b``."""
    rng = np.random.default_rng(99)
    seen = rng.integers(-2 ** 62, 2 ** 62, 20000).astype(np.int64)
    ki = KeyIndex()
    ki.lookup_or_insert(seen)
    dki = dk.DeviceKeyIndex(initial_capacity=1 << 10, device=cuda_device)
    dki.ensure_loaded(ki)
    n, P = 60000, 16
    keys = seen[rng.integers(0, seen.size, n)]
    keys[rng.random(n) < 0.1] = rng.integers(2 ** 62, 2 ** 63 - 1)
    keys[rng.random(n) < 0.1] = seen[3]
    panes = rng.integers(0, P, n).astype(np.int32)
    if value_kind == "float":
        vals = (rng.standard_normal(n) * 10).astype(np.float32)
        dsum = rng.standard_normal(32768 * P)
    else:
        vals = rng.integers(-1000, 1000, n).astype(np.int32)
        dsum = rng.integers(-10 ** 6, 10 ** 6, 32768 * P).astype(np.int64)
    dcnt = rng.integers(0, 5, 32768 * P).astype(np.int32)
    args = [*dki.table(),
            *(torch.from_numpy(a).to(cuda_device)
              for a in (*dki.prepare_batch(keys), panes))]
    cpu_args = [a.cpu() for a in args]
    before = dk.probe_fold.launches
    got = dk.probe_fold(*args, n - 700, torch.from_numpy(vals).to(cuda_device),
                        torch.from_numpy(dsum).to(cuda_device),
                        torch.from_numpy(dcnt).to(cuda_device), P)
    torch.cuda.synchronize()
    assert dk.probe_fold.launches == before + 1
    want = dk.torch_probe_fold(*cpu_args, n - 700, torch.from_numpy(vals),
                               torch.from_numpy(dsum.copy()),
                               torch.from_numpy(dcnt.copy()), P)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[2].cpu(), want[2])
    assert np.array_equal(got[1].cpu().numpy().view(np.int64),
                          want[1].numpy().view(np.int64))


def _run(device, **kw):
    rng = np.random.default_rng(11)
    op = WindowAggOperator(TumblingEventTimeWindows.of(100), SumAggregator(),
                           key_column="k", value_column="v", device=device,
                           **kw)
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


def test_fused_deferred_lane_on_the_card_is_bit_equal_to_the_cpu(cuda_device):
    """Deferred sync with superbatch 4: warm rows fold through the
    ``probe_fold`` kernel, whose fold keeps row order, and fires read the
    host mirror, so the card's fires equal the CPU's bit for bit."""
    kw = dict(device_sync="deferred", superbatch=4)
    before = dk.probe_fold.launches
    gpu, gstats = _run(cuda_device, **kw)
    assert dk.probe_fold.launches > before
    cpu, cstats = _run("cpu", **kw)
    assert gstats == cstats
    assert len(gpu) == len(cpu) > 0
    for g, c in zip(gpu, cpu):
        assert np.array_equal(g.column("k"), c.column("k"))
        assert np.asarray(g.column("result")).tobytes() == \
            np.asarray(c.column("result")).tobytes()

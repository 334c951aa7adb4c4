"""The port on the card: the probe, probe_fold and scatter_fold kernels
against their plain versions, and the window operator on CUDA (host and
device emit tiers) against the same operator on the CPU.

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
from flink_tpu_torch.ops import scatter as sc
from flink_tpu_torch.state import device_keyindex as dk
from flink_tpu_torch.state.keyindex import KeyIndex
from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


_EXTREMES = np.array([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 2 ** 32, 2 ** 62,
                      2 ** 63 - 1, -2 ** 63, -2 ** 63 + 1], np.int64)


def _loaded_table(device, keys, capacity=1 << 10):
    ki = KeyIndex()
    ki.lookup_or_insert(keys)
    dki = dk.DeviceKeyIndex(initial_capacity=capacity, device=device)
    dki.ensure_loaded(ki)
    return ki, dki


def test_probe_kernel_equals_torch_probe(cuda_device):
    """Seen, unseen, negative and extreme keys (half of the extremes in the
    table, half not); the kernel hashes on the card."""
    rng = np.random.default_rng(1234)
    keys = np.concatenate([rng.integers(-2 ** 62, 2 ** 62, 20000),
                           _EXTREMES[::2]]).astype(np.int64)
    ki, dki = _loaded_table(cuda_device, keys)
    batch = np.concatenate([keys, rng.integers(2 ** 62, 2 ** 63 - 1, 3000),
                            -rng.integers(1, 2 ** 62, 3000), _EXTREMES])
    rng.shuffle(batch)
    kt = torch.from_numpy(batch).to(cuda_device)
    before = dk.probe.launches
    got = dk.probe(dki.buckets, kt)
    torch.cuda.synchronize()
    assert dk.probe.launches == before + 1
    assert torch.equal(got, dk.torch_probe(dki.buckets, kt))
    assert np.array_equal(got.cpu().numpy(), ki.lookup(batch))


def _fold_case(rng, case, value_kind):
    """(seen keys, flush keys, pane slots, b, n_cells, P) of one case."""
    P = 16
    seen = np.concatenate([rng.integers(-2 ** 62, 2 ** 62, 20000),
                           _EXTREMES]).astype(np.int64)
    n = 60000
    keys = seen[rng.integers(0, seen.size, n)]
    keys[rng.random(n) < 0.1] = rng.integers(2 ** 62, 2 ** 63 - 1)
    panes = rng.integers(0, P, n).astype(np.int32)
    n_cells, b = 32768 * P, n - 700
    if case == "hot_cell":          # one cell's run spans many fold chunks
        hot = rng.random(n) < 0.25
        keys[hot] = seen[3]
        panes[hot] = 5
    elif case == "many_tiles":      # 1024 tiles of 256 cells, all used
        n_cells = 1 << 18
    elif case == "empty_tiles":     # cells in a few tiles only
        keys = seen[rng.integers(0, 40, n)]
    elif case == "sparse_last_tile":   # n_cells not a multiple of the tile
        n_cells = 20021 * P + 3
    elif case == "outside":         # cells past n_cells, negative panes
        n_cells = 7000 * P + 9
        panes[rng.random(n) < 0.05] = -1
    return seen, keys, panes, b, n_cells, P


@pytest.mark.parametrize("value_kind", ["f32", "f64", "i32", "i64"])
@pytest.mark.parametrize("case", ["uniform", "hot_cell", "many_tiles",
                                  "empty_tiles", "sparse_last_tile",
                                  "outside"])
def test_probe_fold_kernel_equals_torch_probe_fold(cuda_device, case,
                                                   value_kind):
    """The fused kernels on the card against the plain version on CPU copies
    of the same tensors: ``slot``, ``dcnt`` and ``dsum`` bit for bit (the
    fold keeps row order per cell), with unseen keys, rows past ``b``, and
    per case a hot cell longer than a fold chunk, cells over all 1024 tiles,
    tiles left empty, a short last tile, and cells outside the planes."""
    rng = np.random.default_rng(99)
    seen, keys, panes, b, n_cells, P = _fold_case(rng, case, value_kind)
    _ki, dki = _loaded_table(cuda_device, seen)
    n = keys.size
    vals = {"f32": (rng.standard_normal(n) * 10).astype(np.float32),
            "f64": rng.standard_normal(n) * 10,
            "i32": rng.integers(-1000, 1000, n).astype(np.int32),
            "i64": rng.integers(-2 ** 40, 2 ** 40, n)}[value_kind]
    if value_kind.startswith("f"):
        dsum = rng.standard_normal(n_cells)
    else:
        dsum = rng.integers(-10 ** 6, 10 ** 6, n_cells).astype(np.int64)
    dcnt = rng.integers(0, 5, n_cells).astype(np.int32)
    bits, tiles, _ = dk.fold_plan(n, n_cells)
    if case == "many_tiles":
        assert tiles == dk.FOLD_MAX_TILES
    if case == "sparse_last_tile":
        assert n_cells % (1 << bits)
    cpu = [torch.from_numpy(a) for a in (keys, panes, vals)]
    args = [t.to(cuda_device) for t in cpu]
    before = dk.probe_fold.launches
    got = dk.probe_fold(dki.buckets, args[0], args[1], b, args[2],
                        torch.from_numpy(dsum).to(cuda_device),
                        torch.from_numpy(dcnt).to(cuda_device), P)
    torch.cuda.synchronize()
    assert dk.probe_fold.launches == before + 1
    want = dk.torch_probe_fold(dki.buckets.cpu(), cpu[0], cpu[1], b, cpu[2],
                               torch.from_numpy(dsum.copy()),
                               torch.from_numpy(dcnt.copy()), P)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[2].cpu(), want[2])
    assert np.array_equal(got[1].cpu().numpy().view(np.int64),
                          want[1].numpy().view(np.int64))
    folded = want[2].numpy().astype(np.int64) - dcnt
    assert folded.sum() > 0
    if case == "hot_cell":
        assert folded.max() > 4 * 2048, "the hot run fits one fold chunk"
    if case == "empty_tiles":
        per_tile = np.bincount(np.flatnonzero(folded) >> bits,
                               minlength=tiles)
        assert (per_tile == 0).sum() > tiles // 2


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


def _scatter_case(rng, case, n_cells=(1 << 14) * 16, n=70000):
    """Host flat ids of one case (about 5% dropped, as the id n_cells)."""
    ids = rng.integers(0, n_cells, n)
    if case == "skewed":            # one cell on 25% of the rows
        ids[rng.random(n) < 0.25] = 12345
    elif case == "empty_tiles":     # cells in a few tiles only
        ids = rng.integers(0, 4000, n)
    ids[rng.random(n) < 0.05] = n_cells
    return ids


@pytest.mark.parametrize("ids_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("value_kind", ["f32", "f64", "i32", "i64"])
@pytest.mark.parametrize("case", ["uniform", "skewed", "empty_tiles"])
def test_scatter_fold_kernel_equals_its_plain_version(cuda_device, case,
                                                      value_kind, ids_dtype):
    """``ordered_fold_counts`` on the card (one ``csrc/scatter_fold.cu``
    launch) against the plain version on CPU copies: the plane and the
    counts bit for bit, dropped ids folding nothing."""
    rng = np.random.default_rng(7)
    n_cells = (1 << 14) * 16
    ids = _scatter_case(rng, case, n_cells).astype(ids_dtype)
    n = ids.size
    dtype = {"f32": np.float32, "f64": np.float64, "i32": np.int32,
             "i64": np.int64}[value_kind]
    if value_kind.startswith("f"):
        vals = (rng.standard_normal(n) * 10).astype(np.float32)
        plane = rng.standard_normal(n_cells).astype(dtype)
    else:
        vals = rng.integers(-1000, 1000, n).astype(dtype)
        plane = rng.integers(-10 ** 6, 10 ** 6, n_cells).astype(dtype)
    counts = rng.integers(0, 5, n_cells).astype(np.int32)
    cpu = [torch.from_numpy(a) for a in (plane, counts, ids, vals)]
    dev = [t.to(cuda_device) for t in cpu]
    before = sc.ordered_fold_counts.launches
    (got,), got_c = sc.ordered_fold_counts((dev[0],), dev[1], dev[2],
                                           (dev[3],), ("add",))
    torch.cuda.synchronize()
    assert sc.ordered_fold_counts.launches == before + 1
    (want,), want_c = sc.scatter_fold_counts((cpu[0].clone(),),
                                             cpu[1].clone(), cpu[2],
                                             (cpu[3],), ("add",))
    assert torch.equal(got_c.cpu(), want_c)
    assert got.cpu().numpy().tobytes() == want.numpy().tobytes()
    assert (want_c.numpy() - counts).sum() == int((ids < n_cells).sum())
    if case == "skewed":
        assert (want_c.numpy() - counts).max() > 4 * 2048


@pytest.mark.parametrize("kinds", [("add", "add"), ("min",), ("max", "add")])
def test_scatter_fold_trees_fold_counts_once(cuda_device, kinds):
    """Several leaves: each ``add`` leaf is one launch, the counts fold in
    the first; with no ``add`` leaf the counts take one launch of ones;
    ``min``/``max`` leaves take ``scatter_reduce_``.  Equal to the plain
    version bit for bit."""
    rng = np.random.default_rng(8)
    n_cells = 5000 * 16
    ids = _scatter_case(rng, "uniform", n_cells, 30000).astype(np.int32)
    vals = [(rng.standard_normal(ids.size) * 10).astype(np.float32)
            for _ in kinds]
    init = {"add": 0.0, "min": np.inf, "max": -np.inf}
    planes = [np.full(n_cells, init[k], np.float32) for k in kinds]
    counts = np.zeros(n_cells, np.int32)
    before = sc.ordered_fold_counts.launches
    got, got_c = sc.ordered_fold_counts(
        tuple(torch.from_numpy(p).to(cuda_device) for p in planes),
        torch.from_numpy(counts).to(cuda_device),
        torch.from_numpy(ids).to(cuda_device),
        tuple(torch.from_numpy(v).to(cuda_device) for v in vals), kinds)
    torch.cuda.synchronize()
    assert sc.ordered_fold_counts.launches - before == max(
        1, kinds.count("add"))
    want, want_c = sc.scatter_fold_counts(
        tuple(torch.from_numpy(p.copy()) for p in planes),
        torch.from_numpy(counts.copy()), torch.from_numpy(ids),
        tuple(torch.from_numpy(v) for v in vals), kinds)
    assert torch.equal(got_c.cpu(), want_c)
    for g, w in zip(got, want):
        assert g.cpu().numpy().tobytes() == w.numpy().tobytes()


def test_device_tier_on_the_card_is_bit_equal_to_the_cpu(cuda_device):
    """The device emit tier (and its async twin) on the card: the replica
    folds through ``scatter_fold`` in row order, fires gather from it, so
    every fire equals the CPU's bit for bit."""
    kw = dict(emit_tier="device", snapshot_source="device", superbatch=4,
              native_emit=True, native_shards=1)
    before = sc.ordered_fold_counts.launches
    gpu, gstats = _run(cuda_device, **kw)
    assert sc.ordered_fold_counts.launches > before
    agpu, _ = _run(cuda_device, async_fire=True, **kw)
    cpu, cstats = _run("cpu", **kw)
    assert gstats == cstats and gstats["enabled"] == 0
    assert len(gpu) == len(agpu) == len(cpu) > 0
    for g, a, c in zip(gpu, agpu, cpu):
        for b in (g, a):
            assert np.array_equal(b.column("k"), c.column("k"))
            assert np.asarray(b.column("result")).tobytes() == \
                np.asarray(c.column("result")).tobytes()

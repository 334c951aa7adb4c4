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


#: the lane ``_run`` builds where a test leaves an option out: the host
#: tier, numpy mirror, scatter sync, probe on (pinned on both devices: the
#: ``auto`` defaults would resolve differently on the card and the CPU)
PINNED = dict(emit_tier="host", snapshot_source="mirror", native_emit=False,
              device_sync="scatter", device_probe="on")


def _run(device, snapshot_at=None, **kw):
    """The small seeded stream through one operator; with ``snapshot_at``
    also the bytes of a snapshot taken after that batch."""
    rng = np.random.default_rng(11)
    op = WindowAggOperator(TumblingEventTimeWindows.of(100), SumAggregator(),
                           key_column="k", value_column="v", device=device,
                           **{**PINNED, **kw})
    out = []
    snap = None
    for i in range(10):
        keys = rng.integers(0, 1500, 4000).astype(np.int64)
        vals = rng.random(4000).astype(np.float32)
        ts = i * 50 + np.sort(rng.integers(0, 50, 4000)).astype(np.int64)
        out += op.process_batch(RecordBatch({"k": keys, "v": vals},
                                            timestamps=ts))
        out += op.process_watermark(Watermark(int(ts.max()) - 1))
        if i == snapshot_at:
            s = op.snapshot_state()
            snap = (np.asarray(s["counts"]).tobytes(),
                    [np.asarray(l).tobytes() for l in s["leaves"]])
    out += op.end_input()
    assert op.verify_mirror()
    if snapshot_at is not None:
        return out, op.device_probe_stats(), snap
    return out, op.device_probe_stats()


def _same_fires(gpu, cpu):
    assert len(gpu) == len(cpu) > 0
    for g, c in zip(gpu, cpu):
        assert int(g.column("window_start")[0]) == \
            int(c.column("window_start")[0])
        assert np.array_equal(g.column("k"), c.column("k"))
        assert np.asarray(g.column("result")).tobytes() == \
            np.asarray(c.column("result")).tobytes()


def test_operator_on_the_card_fires_like_the_cpu(cuda_device):
    """Same stream, same fires, bit for bit: slot ids agree (one numpy
    KeyIndex on both sides), and the probe lane's replica and f64 delta
    ring fold through the ordered ``scatter_fold`` (one multi-plane call a
    batch), so the values are the CPU's."""
    before = dk.probe.launches
    multi = sc.ordered_fold_counts_multi.launches
    gpu, gstats = _run(cuda_device)
    assert dk.probe.launches - before == 10
    assert sc.ordered_fold_counts_multi.launches - multi == 10
    cpu, cstats = _run("cpu")
    assert gstats == cstats
    _same_fires(gpu, cpu)


@pytest.mark.parametrize("lane", [
    dict(device_sync="scatter", superbatch=1),                  # path 1
    dict(device_sync="scatter", superbatch=1, native_emit=True,
         native_shards=2),                                       # path 3
    dict(device_sync="deferred", superbatch=1),
    dict(device_sync="deferred", superbatch=1, native_emit=True,
         native_shards=2)])
def test_probe_lanes_on_the_card_are_bit_equal_to_the_cpu(cuda_device,
                                                          lane):
    """The probe-on host tier (the chip smoke's paths 1 and 3, and their
    deferred twins, one batch at a time): the replica and delta folds go
    through the ordered fold, never ``index_add_``, so every fire and the
    mid-run snapshot's bytes equal the CPU run's bit for bit."""
    single = sc.ordered_fold_counts.launches
    multi = sc.ordered_fold_counts_multi.launches
    gpu, gstats, gsnap = _run(cuda_device, snapshot_at=5, **lane)
    if lane["device_sync"] == "scatter":
        assert sc.ordered_fold_counts_multi.launches > multi
    else:
        assert sc.ordered_fold_counts.launches > single
    cpu, cstats, csnap = _run("cpu", snapshot_at=5, **lane)
    assert gstats == cstats and gstats["probe_hits"] > 0
    assert gsnap == csnap
    _same_fires(gpu, cpu)


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
    """Host flat ids of one case (about 5% dropped, as the id n_cells);
    ``n`` is not a multiple of the partition's block."""
    if case == "no_rows":
        return np.zeros(0, np.int64)
    ids = rng.integers(0, n_cells, n)
    if case == "skewed":            # one cell on 25% of the rows
        ids[rng.random(n) < 0.25] = 12345
    elif case == "empty_tiles":     # cells in a few tiles only
        ids = rng.integers(0, 4000, n)
    elif case == "all_dropped":
        ids[:] = n_cells
    elif case == "short_last_tile":     # the last tile's cells are hot
        hot = rng.random(n) < 0.3
        ids[hot] = n_cells - 1 - rng.integers(0, 3, int(hot.sum()))
    ids[rng.random(n) < 0.05] = n_cells
    return ids


_SCATTER_CASES = ["uniform", "skewed", "empty_tiles", "no_rows",
                  "all_dropped", "short_last_tile"]


def _scatter_cells(case):
    return (1 << 14) * 16 + (12345 if case == "short_last_tile" else 0)


def _scatter_inputs(rng, case, value_kind, ids_dtype):
    n_cells = _scatter_cells(case)
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
    return ids, vals, plane, counts


@pytest.mark.parametrize("ids_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("value_kind", ["f32", "f64", "i32", "i64"])
@pytest.mark.parametrize("case", _SCATTER_CASES)
def test_scatter_fold_kernel_equals_its_plain_version(cuda_device, case,
                                                      value_kind, ids_dtype):
    """``ordered_fold_counts`` on the card (one ``csrc/scatter_fold.cu``
    launch: partition, then fold) against the plain version on CPU copies:
    the plane and the counts bit for bit, dropped ids folding nothing; a
    hot cell longer than a fold chunk, tiles left empty, no rows (no
    launch), every row dropped, and a short last tile full of rows."""
    rng = np.random.default_rng(7)
    ids, vals, plane, counts = _scatter_inputs(rng, case, value_kind,
                                               ids_dtype)
    n_cells = plane.size
    bits, tiles, _ = sc.scatter_plan(ids.size, n_cells)
    if case == "short_last_tile":
        assert n_cells % (1 << bits)
    cpu = [torch.from_numpy(a) for a in (plane, counts, ids, vals)]
    dev = [t.to(cuda_device) for t in cpu]
    before = sc.ordered_fold_counts.launches
    (got,), got_c = sc.ordered_fold_counts((dev[0],), dev[1], dev[2],
                                           (dev[3],), ("add",))
    torch.cuda.synchronize()
    assert sc.ordered_fold_counts.launches == before + (ids.size > 0)
    (want,), want_c = sc.scatter_fold_counts((cpu[0].clone(),),
                                             cpu[1].clone(), cpu[2],
                                             (cpu[3],), ("add",))
    assert torch.equal(got_c.cpu(), want_c)
    assert got.cpu().numpy().tobytes() == want.numpy().tobytes()
    folded = want_c.numpy() - counts
    assert folded.sum() == int((ids < n_cells).sum())
    if case == "skewed":
        assert folded.max() > 2 * sc.SCATTER_CHUNK
    if case == "short_last_tile":
        assert folded[(tiles - 1) << bits:].sum() > 2 * sc.SCATTER_CHUNK


@pytest.mark.parametrize("kinds", [("add", "add"), ("min",), ("max", "add")])
def test_scatter_fold_trees_fold_counts_once(cuda_device, kinds):
    """Several leaves: every ``add`` leaf and the counts fold in one launch
    (the rows are partitioned once); with no ``add`` leaf the launch folds
    the counts alone, with no column of ones; ``min``/``max`` leaves take
    ``scatter_reduce_``.  Equal to the plain version bit for bit."""
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
    assert sc.ordered_fold_counts.launches - before == 1
    want, want_c = sc.scatter_fold_counts(
        tuple(torch.from_numpy(p.copy()) for p in planes),
        torch.from_numpy(counts.copy()), torch.from_numpy(ids),
        tuple(torch.from_numpy(v) for v in vals), kinds)
    assert torch.equal(got_c.cpu(), want_c)
    for g, w in zip(got, want):
        assert g.cpu().numpy().tobytes() == w.numpy().tobytes()


@pytest.mark.parametrize("ids_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case", ["uniform", "skewed", "all_dropped",
                                  "short_last_tile"])
@pytest.mark.parametrize("tree", ["sum", "avg"])
def test_multi_plane_fold_equals_its_plain_version(cuda_device, tree, case,
                                                   ids_dtype):
    """``ordered_fold_counts_multi``: the probe lane's replica (f32, or an
    f32 sum and an int32 count for ``avg``) and delta ring (f64, i64) over
    one set of ids, from the same lifted columns (widened on the card), and
    both int32 count planes, in one launch, bit for bit against a loop of
    the plain version."""
    rng = np.random.default_rng(21)
    ids, vals, _, _ = _scatter_inputs(rng, case, "f32", ids_dtype)
    n_cells = _scatter_cells(case)
    lifted = [vals] + ([np.ones(ids.size, np.int32)] if tree == "avg"
                       else [])
    kinds = ("add",) * len(lifted)
    rep = [rng.standard_normal(n_cells).astype(np.float32)] + (
        [rng.integers(0, 9, n_cells).astype(np.int32)] if tree == "avg"
        else [])
    delta = [rng.standard_normal(n_cells)] + (
        [rng.integers(0, 9, n_cells).astype(np.int64)] if tree == "avg"
        else [])
    cnts = [rng.integers(0, 5, n_cells).astype(np.int32) for _ in range(2)]

    def groups(dev):
        def up(a):
            return torch.from_numpy(a.copy()).to(dev)
        lift = tuple(up(v) for v in lifted)
        return [(tuple(up(p) for p in rep), up(cnts[0]), lift),
                (tuple(up(p) for p in delta), up(cnts[1]), lift)]

    before = sc.ordered_fold_counts_multi.launches
    got = sc.ordered_fold_counts_multi(
        groups(cuda_device), torch.from_numpy(ids).to(cuda_device), kinds)
    torch.cuda.synchronize()
    assert sc.ordered_fold_counts_multi.launches - before == 1
    want = sc.scatter_fold_counts_multi(groups("cpu"), torch.from_numpy(ids),
                                        kinds)
    for (gl, gc), (wl, wc) in zip(got, want):
        assert torch.equal(gc.cpu(), wc)
        for g, w in zip(gl, wl):
            assert g.dtype == w.dtype
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


def _paged_run(device, policy, pipeline_depth=0):
    """The small seeded stream through a paged device-tier operator (a ring
    of 256 rows under 1500 keys, a spill budget that sends cells to the
    log); fires, the bytes of a mid-run snapshot, and the counters."""
    from flink_tpu_torch.state.paging import PagingConfig
    rng = np.random.default_rng(11)
    op = WindowAggOperator(
        TumblingEventTimeWindows.of(100), SumAggregator(), key_column="k",
        value_column="v", device=device, emit_tier="device",
        snapshot_source="device", native_emit=True, native_shards=1,
        paging=PagingConfig(256, policy=policy, mem_budget=4096),
        pipeline_depth=pipeline_depth)
    out, snap = [], None
    for i in range(10):
        keys = rng.integers(0, 1500, 4000).astype(np.int64)
        vals = rng.random(4000).astype(np.float32)
        ts = i * 50 + np.sort(rng.integers(0, 50, 4000)).astype(np.int64)
        out += op.process_batch(RecordBatch({"k": keys, "v": vals},
                                            timestamps=ts))
        out += op.process_watermark(Watermark(int(ts.max()) - 1))
        if i == 5:
            s = op.snapshot_state()
            snap = (np.asarray(s["counts"]).tobytes(),
                    [np.asarray(l).tobytes() for l in s["leaves"]],
                    s["paging_stats"])
    out += op.end_input()
    stats = op.paging_stats()
    op.close()
    return out, snap, stats


@pytest.mark.parametrize("policy", ["clock", "lru"])
def test_paged_device_tier_on_the_card_is_bit_equal_to_the_cpu(cuda_device,
                                                                policy):
    """Paging on the card: page-outs gather and download, promotions upload
    and set, spilled keys fire from uploaded cells, and every fire, the
    mid-run snapshot's bytes and the counters equal the CPU run's."""
    before = sc.ordered_fold_counts.launches
    gpu, gsnap, gstats = _paged_run(cuda_device, policy)
    assert sc.ordered_fold_counts.launches > before
    cpu, csnap, cstats = _paged_run("cpu", policy)
    assert gstats == cstats
    assert gstats["evictions"] > 0 and gstats["promotions"] > 0
    assert gstats["spill_log_bytes"] > 0
    assert gsnap == csnap
    _same_fires(gpu, cpu)


def test_row_pane_helpers_on_the_card_equal_the_cpu(cuda_device):
    """The page-out gather and the page-in reset and set on the card, with
    row and pane ids at the ring's edges, equal the CPU's bit for bit."""
    K, P = 1 << 12, 16
    rng = np.random.default_rng(3)
    leaf = torch.from_numpy((rng.random((K, P)) * 10).astype(np.float32))
    counts = torch.from_numpy(rng.integers(0, 5, (K, P)).astype(np.int32))
    rows = torch.from_numpy(np.r_[K - 1, 0, rng.choice(
        np.arange(1, K - 1), 500, replace=False)].astype(np.int64))
    slots = torch.tensor([P - 1, 0, 7], dtype=torch.int64)
    cols = torch.from_numpy((rng.random((rows.numel(), 3)) * 3)
                            .astype(np.float32))
    ccols = torch.from_numpy(rng.integers(1, 9, (rows.numel(), 3))
                             .astype(np.int32))
    inits = (np.float32(0),)

    def on(dev):
        d = lambda t: t.to(dev, copy=True)  # noqa: E731
        gc, (gl,) = sc.gather_row_pane_columns((d(leaf),), d(counts),
                                               d(rows), d(slots))
        l2, c2 = d(leaf), d(counts)
        sc.set_row_pane_columns((l2,), c2, d(rows), d(slots), (d(cols),),
                                d(ccols), inits)
        l3, c3 = d(leaf), d(counts)
        sc.reset_rows((l3,), c3, d(rows[::2]), inits)
        return [t.cpu().numpy().tobytes() for t in (gc, gl, l2, c2, l3, c3)]

    assert on(cuda_device) == on("cpu")


# ---------------------------------------------------------------------------
# the pipeline, the calibration and the upload sets on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lane", [
    dict(native_emit=True, native_shards=2),                    # path 9
    dict(device_sync="deferred", superbatch=4),
    dict(emit_tier="device", snapshot_source="device", native_emit=True,
         native_shards=1)])
def test_pipelined_runs_on_the_card_are_bit_equal_to_depth_0(cuda_device,
                                                             lane):
    """The hot stage on the worker thread (its launches on the card, under
    the operator's device): fires, the mid-run snapshot's bytes and the
    probe counters equal the serial run's and the CPU's bit for bit."""
    serial = _run(cuda_device, snapshot_at=5, **lane)
    for depth in (1, 2):
        got = _run(cuda_device, snapshot_at=5, pipeline_depth=depth, **lane)
        assert got[1] == serial[1] and got[2] == serial[2]
        _same_fires(got[0], serial[0])
    cpu = _run("cpu", snapshot_at=5, pipeline_depth=2, **lane)
    assert cpu[1] == serial[1] and cpu[2] == serial[2]
    _same_fires(cpu[0], serial[0])


def test_pipelined_paged_run_on_the_card_is_bit_equal_to_depth_0(
        cuda_device):
    """Path 10's lane at a small size: paging behind the pipeline."""
    serial = _paged_run(cuda_device, "clock")
    got = _paged_run(cuda_device, "clock", pipeline_depth=2)
    assert got[2] == serial[2] and got[2]["evictions"] > 0
    assert got[1] == serial[1]
    _same_fires(got[0], serial[0])


def test_device_probe_calibration_launches_the_kernels(cuda_device,
                                                       monkeypatch):
    """``calibrated_device_probe`` on the card: an untimed round and two
    timed ones, each a ``probe`` launch and an ordered fold launch, and a
    bool verdict from both sides' seconds (the verdict is put back)."""
    from flink_tpu_torch.state import native_mirror as nm
    monkeypatch.delenv("FLINK_TPU_DEVICE_PROBE", raising=False)
    monkeypatch.setattr(dk, "_calibrated_probe", None)
    monkeypatch.setattr(dk, "last_measurement", {})
    monkeypatch.setattr(nm, "_calibrated_shards", 1)
    before = (dk.probe.launches, sc.ordered_fold_counts.launches)
    verdict = dk.calibrated_device_probe(cuda_device)
    assert isinstance(verdict, bool)
    assert dk.probe.launches == before[0] + 3
    assert sc.ordered_fold_counts.launches == before[1] + 3
    m = dk.last_measurement
    assert m["host_s"] > 0 and m["device_s"] > 0
    assert verdict == (m["device_s"] < m["host_s"])


def _tight_loop(device, pageable, n_batches=24, B=1 << 16):
    """Back-to-back batches through the scatter lane, the card held busy
    before every upload (so the uploads of batch i are still queued while
    the host fills batch i+1): the fires, the final snapshot's bytes and,
    per batch, whether the set it took was one already used."""
    op = WindowAggOperator(TumblingEventTimeWindows.of(10_000),
                           SumAggregator(), key_column="k", value_column="v",
                           device=device, **{**PINNED, "device_probe": "off"})
    staged = op._staged_update
    seen, reused = set(), []

    def busy_then_upload(staging, *a, **kw):
        torch.cuda._sleep(2_000_000)
        reused.append(id(staging) in seen)
        seen.add(id(staging))
        staged(staging, *a, **kw)

    op._staged_update = busy_then_upload
    if pageable:
        from flink_tpu_torch.operators import window_agg as wa
        op._staging_acquire = lambda rows, dt, leaves: wa._Staging(
            rows, dt, leaves, pin=False)
    rng = np.random.default_rng(21)
    out = []
    for i in range(n_batches):
        keys = rng.integers(0, 50_000, B).astype(np.int64)
        vals = rng.random(B).astype(np.float32)
        ts = np.full(B, i * 100, np.int64)
        out += op.process_batch(RecordBatch({"k": keys, "v": vals},
                                            timestamps=ts))
    snap = op.snapshot_state()
    out += op.end_input()
    torch.cuda.synchronize()
    return out, (np.asarray(snap["counts"]).tobytes(),
                 [np.asarray(l).tobytes() for l in snap["leaves"]]), \
        reused, op


def test_pinned_staging_reuse_is_bit_equal_to_pageable_uploads(cuda_device):
    """Pinned upload sets reused under a tight loop (a set goes back into
    use only once the event after its launches completed) give the fires
    and replica of pageable uploads bit for bit; a set reused while its
    copy was still queued would corrupt a later batch silently."""
    got, gsnap, reused, op = _tight_loop(cuda_device, pageable=False)
    pool = [s for sets in op._staging_pool.values() for s in sets]
    assert pool and all(s.flat.is_pinned() for s in pool)
    assert any(reused), "no upload set was reused"
    assert op.verify_mirror()
    want, wsnap, _, _ = _tight_loop(cuda_device, pageable=True)
    assert gsnap == wsnap
    _same_fires(got, want)


def test_worker_cuda_error_reraises_at_every_barrier(cuda_device,
                                                     monkeypatch):
    """A CUDA error raised in a stage on the worker (a device allocation
    that fails, made in place of the device step) parks the worker and
    re-raises at every barrier until ``close()``; the card stays usable.
    The watchdog is off here: under it an OOM with no pager retries and
    quarantines (``test_real_out_of_memory_error_classifies_as_oom``)."""
    monkeypatch.setenv("FLINK_TPU_DEVICE_WATCHDOG", "off")
    op = WindowAggOperator(TumblingEventTimeWindows.of(100), SumAggregator(),
                           key_column="k", value_column="v",
                           device=cuda_device, pipeline_depth=2,
                           **{**PINNED, "device_probe": "off"})

    def failing_step(flat_ids, values):
        torch.empty(1 << 50, dtype=torch.uint8, device=flat_ids.device)

    op._update_step = failing_step
    batch = RecordBatch({"k": np.arange(64, dtype=np.int64),
                         "v": np.ones(64, np.float32)},
                        timestamps=np.zeros(64, np.int64))
    op.process_batch(batch)
    for barrier in (op.flush_pipeline, lambda: op.process_batch(batch),
                    op.snapshot_state, op.end_input):
        with pytest.raises(torch.OutOfMemoryError):
            barrier()
    with pytest.raises(torch.OutOfMemoryError):
        op.close()
    assert op.flush_pipeline() == []
    ok = _run(cuda_device)
    assert len(ok[0]) > 0


# ---------------------------------------------------------------------------
# the device watchdog on the card
# ---------------------------------------------------------------------------

def _fast_monitor(**kw):
    from flink_tpu_torch.runtime import device_health as dh
    cfg = dh.WatchdogConfig(deadline_floor_s=0.25,
                            first_dispatch_grace_s=60.0,
                            backoff_initial_s=0.001, backoff_max_s=0.01)
    mon = dh.DeviceHealthMonitor(cfg, heal_async=False, **kw)
    dh.set_monitor(mon)
    return mon


@pytest.fixture
def monitor():
    """A fast monitor for the test, the process's put back after it."""
    from flink_tpu_torch.runtime import device_health as dh
    from flink_tpu_torch.testing import chaos
    prev = dh.get_monitor(create=False)
    yield _fast_monitor
    dh.set_monitor(prev)
    chaos.uninstall()


def _device_tier(device, **kw):
    return WindowAggOperator(TumblingEventTimeWindows.of(100),
                             SumAggregator(), key_column="k",
                             value_column="v", device=device,
                             emit_tier="device", snapshot_source="device",
                             device_sync="scatter", **kw)


def _small_batches(n=10, seed=11):
    rng = np.random.default_rng(seed)
    for i in range(n):
        keys = rng.integers(0, 1500, 4000).astype(np.int64)
        vals = rng.random(4000).astype(np.float32)
        ts = i * 50 + np.sort(rng.integers(0, 50, 4000)).astype(np.int64)
        yield i, RecordBatch({"k": keys, "v": vals}, timestamps=ts), ts


def test_guarded_dispatch_launches_scatter_fold_on_a_lane_thread(
        cuda_device, monitor, monkeypatch):
    """Each batch's replica fold is one guarded dispatch: it runs on the
    monitor's lane thread (not the caller's), with the operator's card as
    that thread's current device, and launches ``scatter_fold``."""
    import threading

    from flink_tpu_torch.operators import window_agg as wa
    mon = monitor()
    seen = []
    real = wa.ordered_fold_counts

    def recording(*args, **kw):
        seen.append((threading.current_thread().name,
                     torch.cuda.current_device()))
        return real(*args, **kw)
    monkeypatch.setattr(wa, "ordered_fold_counts", recording)
    op = _device_tier(cuda_device)
    before = sc.ordered_fold_counts.launches
    for _, batch, ts in _small_batches(4):
        op.process_batch(batch)
    torch.cuda.synchronize()
    assert len(seen) == 4 and sc.ordered_fold_counts.launches == before + 4
    assert all(name.startswith("device-lane")
               and dev == (cuda_device.index or 0) for name, dev in seen)
    assert mon.counters["dispatches"] == 4
    assert op.fused_stats()["hot_dispatches"] == 4
    assert op._fence is not None and op._fence.query()


def _cycle(device, wedge_at=None, busy_at=None, n=10):
    """The device tier over the small stream (one guarded dispatch a
    batch; a window fires in the watermark after every even batch from 2
    on, and the fire's download waits for the card); ``wedge_at``: a
    chaos wedge at that dispatch; ``busy_at``: the card held busy
    (``torch.cuda._sleep``, about 2 s, which ends by itself) before that
    (odd, non-firing) batch, so the NEXT dispatch's fence wait trips its
    deadline.  Heal after batch 6 and re-promote at batch 8.  Returns
    (fires, health stats, monitor)."""
    from flink_tpu_torch.runtime import device_health as dh
    from flink_tpu_torch.testing import chaos
    mon = dh.get_monitor()
    inj = chaos.FaultInjector(seed=1)
    sched = (inj.inject("device.dispatch", chaos.WedgedDevice(at=wedge_at))
             if wedge_at else None)
    op = _device_tier(device)
    out = []
    with chaos.installed(inj):
        for i, batch, ts in _small_batches(n):
            if busy_at == i:
                torch.cuda._sleep(4_000_000_000)
            out += op.process_batch(batch)
            out += op.process_watermark(Watermark(int(ts.max()) - 1))
            if i == 6:
                if sched is not None:
                    sched.heal()
                assert mon.probe_now()
            if i == 8:
                out += op.prepare_snapshot_pre_barrier()
        out += op.end_input()
    return out, op.device_health_stats(), mon


def test_event_fence_trips_on_a_kernel_held_busy(cuda_device, monitor):
    """A kernel that outlasts the deadline (``torch.cuda._sleep`` before
    batch 3, behind which batch 3's fold queues) trips batch 4's fence wait
    (dispatch 5): the tier quarantines, migrates (the salvage waits the
    kernel out), continues on the host tier, and re-promotes after the
    heal.  The fires equal the CPU's under a chaos wedge at the same
    dispatch, bit for bit."""
    mon = monitor(probe_fn=lambda: True)
    gpu, ghealth, _ = _cycle(cuda_device, busy_at=3)
    assert mon.counters["watchdog_timeouts"] == 1
    assert mon.counters["quarantines"] == 1 and mon.counters["heals"] == 1
    assert ghealth == {"degraded": 0, "quarantine_migrations": 1,
                       "repromotions": 1}
    monitor()
    cpu, chealth, _ = _cycle("cpu", wedge_at=5)
    assert chealth == ghealth
    _same_fires(gpu, cpu)


def test_real_out_of_memory_error_classifies_as_oom(cuda_device):
    from flink_tpu_torch.runtime import device_health as dh
    with pytest.raises(torch.OutOfMemoryError) as ei:
        torch.empty(1 << 50, dtype=torch.uint8, device=cuda_device)
    assert dh.classify_failure(ei.value) == dh.OOM
    torch.ones(1, device=cuda_device).add_(1)   # the card is still usable
    torch.cuda.synchronize()


def test_quarantine_cycle_on_the_card_equals_the_cpu(cuda_device, monitor):
    """The same chaos wedge (dispatch 4) on the card and on the CPU: the
    same migration, heal and re-promotion, the same fires bit for bit."""
    monitor()
    gpu, ghealth, gmon = _cycle(cuda_device, wedge_at=4)
    monitor()
    cpu, chealth, cmon = _cycle("cpu", wedge_at=4)
    assert ghealth == chealth == {"degraded": 0, "quarantine_migrations": 1,
                                  "repromotions": 1}
    assert gmon.counters["quarantines"] == cmon.counters["quarantines"] == 1
    _same_fires(gpu, cpu)


def test_healer_probe_subprocess_sees_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the probe launches on the card")
    from flink_tpu_torch.runtime import device_health as dh
    assert dh.probe_backend_subprocess(timeout_s=120) is True


# ---------------------------------------------------------------------------
# the key-group mesh on the card
# ---------------------------------------------------------------------------

def _mesh_run(devices, tier="device", keys_fn=None, n=10, **kw):
    """The small seeded stream through a ``MeshWindowAggOperator`` over
    ``devices`` (``["cpu"] * D`` for the CPU twin); fires, the bytes of a
    mid-run snapshot densified, and the counters."""
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.mesh_runtime import MeshWindowAggOperator
    from flink_tpu_torch.state.shard_layout import densify_keyed_snapshot
    rng = np.random.default_rng(11)
    opts = dict(PINNED, emit_tier=tier,
                snapshot_source="mirror" if tier == "host" else "device",
                native_emit=True, native_shards=len(devices))
    opts.update(kw)
    op = MeshWindowAggOperator(TumblingEventTimeWindows.of(100),
                               SumAggregator(), key_column="k",
                               value_column="v",
                               mesh=make_mesh(devices=devices), **opts)
    out, snap = [], None
    for i in range(n):
        keys = (keys_fn(rng, i) if keys_fn is not None
                else rng.integers(0, 1500, 4000).astype(np.int64))
        vals = rng.random(keys.size).astype(np.float32)
        ts = i * 50 + np.sort(rng.integers(0, 50, keys.size)).astype(
            np.int64)
        out += op.process_batch(RecordBatch({"k": keys, "v": vals},
                                            timestamps=ts))
        out += op.process_watermark(Watermark(int(ts.max()) - 1))
        if i == 5:
            out += op.prepare_snapshot_pre_barrier()
            s = densify_keyed_snapshot(op.snapshot_state())
            snap = (np.asarray(s["counts"]).tobytes(),
                    [np.asarray(l).tobytes() for l in s["leaves"]])
    out += op.end_input()
    assert op.verify_mirror()
    stats = (op.device_probe_stats(), op.late_dropped, op._K,
             op.key_index.num_keys)
    op.close()
    return out, snap, stats


@pytest.mark.parametrize("tier", ["device", "host"])
def test_mesh_fold_on_four_blocks_of_one_card_equals_the_cpu(cuda_device,
                                                             tier):
    """Four shard blocks on one card: every block folds its received rows
    through ``scatter_fold`` (the host tier's probe through ``probe``), so
    fires and the snapshot equal the CPU mesh's bit for bit."""
    folds = sc.ordered_fold_counts.launches
    probes = dk.probe.launches
    gpu, gsnap, gstats = _mesh_run([cuda_device] * 4, tier)
    torch.cuda.synchronize()
    assert sc.ordered_fold_counts.launches - folds >= 4 * 10
    if tier == "host":
        assert dk.probe.launches - probes == 10
    cpu, csnap, cstats = _mesh_run(["cpu"] * 4, tier)
    assert gstats == cstats and gsnap == csnap
    _same_fires(gpu, cpu)


def test_mesh_skewed_batch_on_the_card_equals_the_cpu(cuda_device):
    """One hot key on 40% of the rows: one block takes most of every batch
    and the bucket capacity grows to hold it."""
    def skewed(rng, i):
        keys = rng.integers(0, 1500, 4000).astype(np.int64)
        keys[rng.random(4000) < 0.4] = 7
        return keys
    gpu, gsnap, gstats = _mesh_run([cuda_device] * 4, keys_fn=skewed)
    cpu, csnap, cstats = _mesh_run(["cpu"] * 4, keys_fn=skewed)
    assert gstats == cstats and gsnap == csnap
    _same_fires(gpu, cpu)


def test_mesh_growth_across_blocks_on_the_card_equals_the_cpu(cuda_device):
    """Key growth (1500 keys into an initial capacity of 256 at D = 4):
    doubling K moves block boundaries, so rows re-home between blocks."""
    def growing(rng, i):
        return rng.integers(0, 150 * (i + 1), 4000).astype(np.int64)
    gpu, gsnap, gstats = _mesh_run([cuda_device] * 4, keys_fn=growing,
                                   initial_key_capacity=256)
    cpu, csnap, cstats = _mesh_run(["cpu"] * 4, keys_fn=growing,
                                   initial_key_capacity=256)
    assert gstats == cstats and gstats[2] >= 2048
    assert gsnap == csnap
    _same_fires(gpu, cpu)


def test_mesh_over_two_cards_equals_the_cpu(cuda_device):
    """Blocks on two distinct cards: the exchange copies across cards, each
    block's work runs under its card, and the fence waits on both."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    devices = [torch.device("cuda", 0), torch.device("cuda", 1)] * 2
    gpu, gsnap, gstats = _mesh_run(devices, "host")
    cpu, csnap, cstats = _mesh_run(["cpu"] * 4, "host")
    assert gstats == cstats and gsnap == csnap
    _same_fires(gpu, cpu)


# ---------------------------------------------------------------------------
# the generic fold, count triggers and the keyed reduce on the card
# ---------------------------------------------------------------------------

def _combine_add(a, b):
    return (a[0] + b[0],)


def test_generic_scan_on_the_card_equals_the_cpu(cuda_device):
    """``segment_running_fold`` and ``scatter_generic`` (torch ops: a
    stable sort, JAX's scan recursion, one write per segment end) on a
    2^18-row batch: the card's bits are the CPU's."""
    rng = np.random.default_rng(5)
    B, N = 1 << 18, 1 << 16
    ids = rng.integers(0, N + 1, B).astype(np.int32)   # N: dropped rows
    vals = (rng.standard_normal(B) * 10).astype(np.float32)
    vals[rng.random(B) < 0.05] = -0.0
    state = rng.standard_normal(N).astype(np.float32)
    want = sc.segment_running_fold(torch.from_numpy(ids),
                                   (torch.from_numpy(vals),), _combine_add)
    got = sc.segment_running_fold(torch.from_numpy(ids).to(cuda_device),
                                  (torch.from_numpy(vals).to(cuda_device),),
                                  _combine_add)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[2].cpu(), want[2])
    assert got[3][0].cpu().numpy().tobytes() == \
        want[3][0].numpy().tobytes()
    cpu_state = torch.from_numpy(state.copy())
    gpu_state = torch.from_numpy(state.copy()).to(cuda_device)
    sc.scatter_generic((cpu_state,), torch.from_numpy(ids),
                       (torch.from_numpy(vals),), _combine_add, N)
    sc.scatter_generic((gpu_state,), torch.from_numpy(ids).to(cuda_device),
                       (torch.from_numpy(vals).to(cuda_device),),
                       _combine_add, N)
    assert gpu_state.cpu().numpy().tobytes() == cpu_state.numpy().tobytes()


def _count_run(device, assigner, trigger, agg=None):
    """A small seeded stream through a count-triggered (or generic)
    device-tier operator: every fire's keys and result bytes."""
    rng = np.random.default_rng(13)
    op = WindowAggOperator(assigner, agg or SumAggregator(), key_column="k",
                           value_column="v", device=device, trigger=trigger,
                           emit_tier="device", snapshot_source="device",
                           initial_key_capacity=256)
    out = []
    for i in range(8):
        keys = rng.integers(0, 200 * (i + 1), 3000).astype(np.int64)
        vals = rng.standard_normal(3000).astype(np.float32)
        ts = i * 50 + np.sort(rng.integers(0, 50, 3000)).astype(np.int64)
        out += op.process_batch(RecordBatch({"k": keys, "v": vals},
                                            timestamps=ts))
        out += op.process_watermark(Watermark(int(ts.max()) - 1))
    out += op.end_input()
    return [(np.asarray(b.column("k")).tobytes(),
             np.asarray(b.column("result")).tobytes()) for b in out]


@pytest.mark.parametrize("case", ["tumbling-purging", "global-purging",
                                  "sliding-running", "lambda"])
def test_count_trigger_and_generic_operators_on_the_card_equal_the_cpu(
        cuda_device, case):
    from flink_tpu_torch.core.functions import LambdaReduce
    from flink_tpu_torch.windowing.assigners import (GlobalWindows,
                                                     SlidingEventTimeWindows)
    from flink_tpu_torch.windowing.triggers import CountTrigger
    args = {
        "tumbling-purging": lambda: (TumblingEventTimeWindows.of(100),
                                     CountTrigger.of(2, purge=True)),
        "global-purging": lambda: (GlobalWindows.create(),
                                   CountTrigger.of(4, purge=True)),
        "sliding-running": lambda: (SlidingEventTimeWindows.of(300, 100),
                                    CountTrigger.of(3)),
        "lambda": lambda: (TumblingEventTimeWindows.of(100), None,
                           LambdaReduce(lambda a, b: a + b, 0.0)),
    }[case]
    before = sc.ordered_fold_counts.launches
    gpu = _count_run(cuda_device, *args())
    launched = sc.ordered_fold_counts.launches - before
    cpu = _count_run("cpu", *args())
    assert gpu == cpu and gpu
    # the count cases fold through scatter_fold; the generic one never does
    assert (launched > 0) == (case != "lambda")


def test_keyed_reduce_on_the_card_equals_the_cpu(cuda_device):
    from flink_tpu_torch.operators.basic import KeyedReduceOperator
    rng = np.random.default_rng(17)
    runs = {}
    for dev in (cuda_device, "cpu"):
        op = KeyedReduceOperator(SumAggregator(), key_column="k",
                                 value_column="v", device=dev)
        outs = []
        for B in (1 << 16, 1000, 37, 5000):
            keys = rng.integers(0, 3000, B).astype(np.int64)
            vals = rng.standard_normal(B).astype(np.float32)
            (b,) = op.process_batch(RecordBatch({"k": keys, "v": vals}))
            outs.append(np.asarray(b.column("result")).tobytes())
        snap = op.snapshot_state()
        runs[str(dev)] = (outs, [l.tobytes() for l in snap["leaves"]])
        rng = np.random.default_rng(17)
    assert runs[str(cuda_device)] == runs["cpu"]


# ---------------------------------------------------------------------------
# slice 12: the mesh session fold and the device evicting lane
# ---------------------------------------------------------------------------

def _session_batches(n_batches=6, batch=4096, n_keys=3000, seed=17):
    """Config 4's shape, small: Zipf keys, gap-clustered timestamps,
    random f32 values (sums that round, so the fold order shows)."""
    rng = np.random.default_rng(seed)
    out, t = [], 0
    for _ in range(n_batches):
        keys = ((rng.zipf(1.3, batch) - 1) % n_keys).astype(np.int64)
        vals = rng.random(batch).astype(np.float32)
        ts = t + np.sort(rng.integers(0, 800, batch)).astype(np.int64)
        t += 1500
        out.append((keys, vals, ts))
    return out


def _drive_elements(op, batches, end=True):
    out = []
    for keys, vals, ts in batches:
        out += op.process_batch(RecordBatch({"k": keys, "v": vals},
                                            timestamps=ts))
        out += op.process_watermark(Watermark(int(ts.max()) - 1))
    if end:
        out += op.process_watermark(Watermark(1 << 40))
        out += op.end_input()
    return [tuple((c, np.asarray(b.column(c)).dtype.str,
                   np.asarray(b.column(c)).tobytes())
                  for c in sorted(b.columns)) for b in out]


@pytest.mark.parametrize("agg", ["sum", "avg", "max"])
def test_mesh_session_fold_on_four_blocks_of_one_card_equals_the_cpu(
        cuda_device, agg):
    """``MeshSessionWindowOperator`` over ``[cuda] * 4``: fires and
    snapshots bit for bit against ``["cpu"] * 4``; ``scatter_fold``
    launches on the card (one call a block a batch), none on the CPU."""
    from flink_tpu_torch.core.functions import (AvgAggregator, MaxAggregator,
                                                RuntimeContext)
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.mesh_runtime import \
        MeshSessionWindowOperator
    from flink_tpu_torch.windowing.assigners import EventTimeSessionWindows
    make_agg = {"sum": SumAggregator, "avg": AvgAggregator,
                "max": MaxAggregator}[agg]
    batches = _session_batches()
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        op = MeshSessionWindowOperator(
            EventTimeSessionWindows(300), make_agg(torch.float32),
            key_column="k", value_column="v",
            mesh=make_mesh(devices=[dev] * 4))
        op.open(RuntimeContext())
        before = sc.ordered_fold_counts.launches
        fired = _drive_elements(op, batches[:4], end=False)
        snap = op.snapshot_state()
        fired += _drive_elements(op, batches[4:])
        runs.append((fired, snap, sc.ordered_fold_counts.launches - before))
    (gf, gs, gl), (cf, cs, cl) = runs
    assert gf == cf and gf
    for k in ("session_keys", "start", "end", "fired"):
        assert np.array_equal(gs[k], cs[k])
    for a, b in zip(gs["acc"], cs["acc"], strict=True):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert gl == 4 * len(batches) and cl == 0


@pytest.mark.parametrize("evictor", ["count", "time"])
@pytest.mark.parametrize("agg", ["sum", "avg", "max"])
def test_evicting_lane_on_the_card_equals_the_cpu(cuda_device, evictor, agg):
    """``DeviceEvictingWindowOperator`` on the card: every fire and the
    mid-run snapshot bit for bit against the CPU, through buffer growth and
    compaction; one ``scatter_fold`` launch a fire step on the card, none
    on the CPU; the append runs under the watchdog's label."""
    from flink_tpu_torch.core.functions import (AvgAggregator, MaxAggregator,
                                                RuntimeContext)
    from flink_tpu_torch.operators.evicting_device import \
        DeviceEvictingWindowOperator
    from flink_tpu_torch.runtime import device_health as dh
    from flink_tpu_torch.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.windowing.evictors import CountEvictor, TimeEvictor
    make_agg = {"sum": SumAggregator, "avg": AvgAggregator,
                "max": MaxAggregator}[agg]
    rng = np.random.default_rng(21)
    batches = []
    for i in range(12):
        n = 5000 + 331 * i
        batches.append((rng.integers(0, 2000 + 300 * i, n).astype(np.int64),
                        rng.random(n).astype(np.float32),
                        (i * 1000 + np.sort(rng.integers(-300, 1000, n))
                         ).astype(np.int64)))
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        op = DeviceEvictingWindowOperator(
            SlidingEventTimeWindows.of(2000, 1000),
            CountEvictor.of(3) if evictor == "count" else TimeEvictor.of(400),
            make_agg(torch.float32), key_column="k", value_column="v",
            allowed_lateness_ms=200, initial_capacity=1 << 13,
            initial_key_capacity=512, device=dev)
        op.open(RuntimeContext())
        before = sc.ordered_fold_counts.launches
        fired = _drive_elements(op, batches[:7], end=False)
        snap = op.snapshot_state()
        fired += _drive_elements(op, batches[7:])
        runs.append((fired, snap, op.fire_steps,
                     sc.ordered_fold_counts.launches - before, op._C))
    (gf, gs, gsteps, gl, gC), (cf, cs, csteps, cl, cC) = runs
    assert gf == cf and gf and gC == cC
    for k in ("vals", "keys", "panes", "ts"):
        assert gs[k].dtype == cs[k].dtype and gs[k].tobytes() == cs[k].tobytes()
    assert gsteps == csteps and gl == gsteps > 0 and cl == 0
    assert "evicting-window-device.append_step" in \
        dh.status_snapshot()["dispatch_labels"]

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


# ---------------------------------------------------------------------------
# CEP: the vectorized engine's step on the card (torch ops, no kernel)
# ---------------------------------------------------------------------------

def _cep_pattern(within=20000):
    from flink_tpu_torch.cep import Pattern
    return (Pattern.begin("small").where(lambda c: np.asarray(c["v"]) < 30.0)
            .followed_by("large").where(lambda c: np.asarray(c["v"]) > 570.0)
            .within(within))


def _cep_loop_pattern():
    from flink_tpu_torch.cep import Pattern
    kind = lambda x: (lambda c: np.asarray(c["kind"]) == x)  # noqa: E731
    return (Pattern.begin("a").where(kind(0)).one_or_more().until(kind(3))
            .not_followed_by("nb").where(kind(1))
            .followed_by("e").where(kind(2)).within(40))


def _cep_batches(n_batches, n_keys, size, seed, kinds=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        cols = {"k": rng.integers(0, n_keys, size).astype(np.int64),
                "v": rng.random(size) * 600.0}
        if kinds:
            cols["kind"] = rng.integers(0, 5, size).astype(np.int64)
        ts = i * 50 + np.sort(rng.integers(0, 50, size)).astype(np.int64)
        out.append((cols, ts))
    return out


def _cep_run(op, batches, snap_at=None):
    rows, snap = [], None
    for j, (cols, ts) in enumerate(batches):
        out = op.process_batch(RecordBatch(dict(cols), timestamps=ts))
        out += op.process_watermark(Watermark(int(ts.max()) - 1))
        rows += [(tuple((c, np.asarray(b.columns[c])[i].item())
                        for c in sorted(b.columns)),
                  int(np.asarray(b.timestamps)[i]))
                 for b in out for i in range(len(b))]
        if j == snap_at:
            snap = op.snapshot_state()
    for b in op.end_input():
        rows += [(tuple((c, np.asarray(b.columns[c])[i].item())
                        for c in sorted(b.columns)),
                  int(np.asarray(b.timestamps)[i])) for i in range(len(b))]
    return rows, snap


def test_cep_device_step_on_the_card_equals_the_cpu(cuda_device):
    """Every step of two seeded runs (the blocks the operator really feeds,
    with partial and ring growth): the step body on the card equals the
    same body on CPU tensors bit for bit — new block, match plane,
    candidate rings, flags — and ``step_device`` on the card equals
    ``step_numpy``."""
    from flink_tpu_torch.cep import operator as cop
    from flink_tpu_torch.cep import vectorized as cv

    real = cv.step_device
    seen = {"steps": 0}

    def checked(tab, m, block, inputs, device, counters=None, planes=None):
        outs = []
        for dev in (cuda_device, torch.device("cpu")):
            blk = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                        for a in block)
            inp = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in inputs]
            inp[2] = inp[2].long()
            new_block, mm, c_ev, c_eln, flags = cv.device_step(tab, m, blk,
                                                               tuple(inp))
            outs.append([a.cpu().numpy() for a in (*new_block, mm, c_ev,
                                                   c_eln, flags)])
        for a, b in zip(*outs):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        res, m_out = real(tab, m, block, inputs, cuda_device, counters,
                          planes)
        ref, m_ref = cv.step_numpy(tab, m, block, inputs)
        assert m_out == m_ref
        for a, b in zip(res.block, ref.block):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(res.match_kc, ref.match_kc)
        assert all(np.array_equal(a, b)
                   for a, b in zip(res.match_ev, ref.match_ev))
        seen["steps"] += 1
        return res, m_out

    for pattern, kinds in ((_cep_pattern(60), False),
                           (_cep_loop_pattern(), True)):
        op = cop.CepOperator(pattern, "k", lambda m: {"n": len(m)},
                             vectorized="on", device=cuda_device)
        op._resolve_engine()
        assert op._vec.kernel == "device"
        batches = _cep_batches(6, 300, 2000, 3, kinds=kinds)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cv, "step_device", checked)
            _cep_run(op, batches)
    assert seen["steps"] > 10


def test_cep_vectorized_operator_on_the_card_equals_the_numpy_engine(
        cuda_device):
    """``CepOperator(vectorized="on")`` on the card (the device step)
    against the same operator on the CPU with the numpy step and with the
    interpreted engine: rows, order, ``cep_stats()`` counters and the
    mid-run snapshot; the card's snapshot restores into the CPU operator
    and finishes with the same rows."""
    from flink_tpu_torch.cep import operator as cop

    batches = _cep_batches(8, 2000, 4000, 5, kinds=True)
    runs = {}
    for label, device, mode in (("card", cuda_device, "on"),
                                ("numpy", "cpu", "on"),
                                ("interpreted", "cpu", "off")):
        for pattern in (_cep_pattern(120), _cep_loop_pattern()):
            op = cop.CepOperator(pattern, "k",
                                 lambda m: {"k": next(iter(m.values()))[0]["k"],
                                            "n": sum(len(r) for r in m.values())},
                                 vectorized=mode, device=device)
            rows, snap = _cep_run(op, batches, snap_at=3)
            st = op.cep_stats()
            runs.setdefault(label, []).append(
                (rows, st["matches"], st["partials_high_water"], snap,
                 dict(op.step_stats)))
    for (cr, cm, ch, cs, cstats), (nr, nm, nh, ns, _), (ir, im, ih, _s, _) in \
            zip(runs["card"], runs["numpy"], runs["interpreted"]):
        assert cr == nr == ir and cr
        assert cm == nm == im and ch == nh == ih
        assert cstats["steps"] > 0 and cstats["h2d_bytes"] > 0
        assert list(cs["nfas"]) == list(ns["nfas"])
        for k in cs["nfas"]:
            assert cs["nfas"][k][:2] == ns["nfas"][k][:2]
    op = cop.CepOperator(_cep_pattern(120), "k",
                         lambda m: {"k": next(iter(m.values()))[0]["k"],
                                    "n": sum(len(r) for r in m.values())},
                         vectorized="on", device="cpu")
    op.restore_state(runs["card"][0][3])
    rest, _ = _cep_run(op, batches[4:])
    full = runs["numpy"][0][0]
    assert rest == full[len(full) - len(rest):]


def test_cep_wedge_on_the_card_degrades_digest_identical(cuda_device):
    """A ``WedgedDevice`` at the third ``cep.vectorized_drain`` dispatch on
    the card: the operator quarantines, degrades to the interpreted engine
    and its rows equal an unfaulted card run's; the monitor counts one
    timeout and one quarantine."""
    from flink_tpu_torch.cep import operator as cop
    from flink_tpu_torch.runtime import device_health as dh
    from flink_tpu_torch.testing import chaos

    batches = _cep_batches(6, 500, 3000, 8)
    prev = dh.get_monitor(create=False)
    results = []
    try:
        for inject in (False, True):
            mon = dh.DeviceHealthMonitor(
                dh.WatchdogConfig(deadline_floor_s=2.0,
                                  first_dispatch_grace_s=60.0),
                heal_async=False)
            dh.set_monitor(mon)
            inj = chaos.FaultInjector(seed=1)
            wedge = chaos.WedgedDevice(at=3)
            if inject:
                inj.inject("device.dispatch", wedge)
            op = cop.CepOperator(_cep_pattern(120), "k",
                                 lambda m: {"k": m["small"][0]["k"]},
                                 vectorized="on", device=cuda_device)
            try:
                with chaos.installed(inj):
                    rows, _ = _cep_run(op, batches)
            finally:
                wedge.heal()
            results.append((rows, op.cep_stats(), dict(mon.counters)))
    finally:
        dh.set_monitor(prev)
    (clean, cst, cmon), (wedged, wst, wmon) = results
    assert wedged == clean and clean
    assert cst["degraded"] == 0 and cst["engine"] == "vectorized"
    assert wst["degraded"] == 1 and wst["engine"] == "interpreted"
    assert wst["matches"] == cst["matches"]
    assert wmon["quarantines"] == 1 and wmon["watchdog_timeouts"] == 1
    assert cmon["quarantines"] == 0


def test_device_join_on_the_card_equals_the_cpu(cuda_device):
    """``device_join_pairs`` on the card (torch ops) against its plain
    version: uniform keys with absent ones, a skewed key, and empties;
    pairs, order and dtype exactly."""
    from flink_tpu_torch.ops import join_kernels as jk

    rng = np.random.default_rng(28)
    lk = rng.integers(0, 5000, 40_000).astype(np.int64)
    rk = rng.integers(2500, 7500, 30_000).astype(np.int64)
    lk[rng.random(lk.size) < 0.01] = 2 ** 40 + 3
    rk[rng.random(rk.size) < 0.01] = 2 ** 40 + 3
    for a, b in ((lk, rk), (lk[:0], rk), (lk, rk[:0]), (rk, lk)):
        want = jk.device_join_pairs(a, b, device="cpu")
        got = jk.device_join_pairs(a, b, device=cuda_device)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int64
            np.testing.assert_array_equal(g, w)
    tl = torch.from_numpy(lk).to(cuda_device)
    tr = torch.from_numpy(rk).to(cuda_device)
    n = int(jk.pair_count(tl, tr))
    li, ri, pn = jk.pair_emit(tl, tr, n + 100)
    pli, pri, ppn = jk.pair_emit(tl.cpu(), tr.cpu(), n + 100)
    assert int(pn) == int(ppn) == n
    np.testing.assert_array_equal(li.cpu().numpy(), pli.numpy())
    np.testing.assert_array_equal(ri.cpu().numpy(), pri.numpy())


def test_changelog_agg_on_the_card_equals_the_cpu(cuda_device):
    """``ChangelogGroupAggOperator`` (sum, count, min, max) on the card
    against the same operator on the CPU over two batches: rows and
    snapshot words bit for bit; the add words fold through
    ``scatter_fold``."""
    from flink_tpu_torch.operators.sql_ops import ChangelogGroupAggOperator

    aggs = {"s": ("v", "sum"), "n": (None, "count"), "mn": ("v", "min"),
            "mx": ("v", "max")}
    rng = np.random.default_rng(29)
    card = ChangelogGroupAggOperator("k", aggs, device=cuda_device)
    cpu = ChangelogGroupAggOperator("k", aggs, device="cpu")
    sc.ordered_fold_counts_multi.launches = 0
    for _ in range(2):
        k = rng.integers(0, 100_000, 1 << 16).astype(np.int64)
        v = rng.random(1 << 16).astype(np.float32)
        got = card.process_batch(RecordBatch({"k": k, "v": v}))
        want = cpu.process_batch(RecordBatch({"k": k, "v": v}))
        assert len(got) == len(want) == 1
        for c in want[0].columns:
            a, b = np.asarray(got[0].column(c)), np.asarray(want[0].column(c))
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), c
    torch.cuda.synchronize()
    assert sc.ordered_fold_counts_multi.launches == 4
    a, b = card.snapshot_state(), cpu.snapshot_state()
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a["state"],
                                                          b["state"]))


# ---------------------------------------------------------------------------
# the graph library (slice 15)
# ---------------------------------------------------------------------------

def _rmat_edges(scale, edge_factor, seed):
    """A small Kronecker (R-MAT) edge list, initiator (0.57, 0.19, 0.19,
    0.05), labels permuted from the seed."""
    rng = np.random.default_rng(seed)
    m = edge_factor << scale
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for bit in range(scale):
        r = rng.random(m)
        i_bit = r > 0.57 + 0.19
        j_bit = ((r > 0.57) & (r <= 0.76)) | (r > 0.95)
        src |= i_bit.astype(np.int64) << bit
        dst |= j_bit.astype(np.int64) << bit
    perm = rng.permutation(1 << scale)
    return np.stack([perm[src], perm[dst]], 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int32, torch.int64])
def test_graph_sum_combine_on_the_card_equals_the_cpu(cuda_device, dtype):
    """The sum combine folds through ``scatter_fold`` in edge order: bit
    for bit the CPU's ``index_add_``, with a hot vertex and vector
    messages; min/max exactly."""
    from flink_tpu_torch.graph_lib.graph import segment_combine
    rng = np.random.default_rng(15)
    n, e = 1 << 16, 1 << 20
    dst = rng.integers(0, n, e).astype(np.int32)
    dst[::4] = 17                                # a hot vertex
    vals = rng.standard_normal(e) * 1e3
    cases = [vals, np.stack([vals, -vals[::-1]], 1)]
    for msgs in cases:
        m = torch.from_numpy(msgs).to(dtype)
        want = segment_combine(m, torch.from_numpy(dst), n, "sum")
        before = sc.ordered_fold.launches
        got = segment_combine(m.to(cuda_device),
                              torch.from_numpy(dst).to(cuda_device), n,
                              "sum")
        assert sc.ordered_fold.launches == before + 1
        assert torch.equal(got.cpu(), want)
        for kind in ("min", "max"):
            assert torch.equal(
                segment_combine(m.to(cuda_device),
                                torch.from_numpy(dst).to(cuda_device), n,
                                kind).cpu(),
                segment_combine(m, torch.from_numpy(dst), n, kind))


def test_graph_algorithms_on_the_card_equal_the_cpu(cuda_device):
    """Every order-free algorithm exactly; PageRank and HITS to rtol 1e-5
    (their sum and norm reductions group differently on the card; the
    per-vertex sums are bit-equal)."""
    from flink_tpu_torch.graph_lib import Graph
    e = _rmat_edges(12, 8, 3)
    rng = np.random.default_rng(5)
    w = rng.random(len(e)).astype(np.float32)
    card = Graph.from_edges(e, num_vertices=4096, weights=w,
                            device=cuda_device)
    cpu = Graph.from_edges(e, num_vertices=4096, weights=w, device="cpu")
    before = sc.ordered_fold.launches
    np.testing.assert_array_equal(card.out_degrees(), cpu.out_degrees())
    np.testing.assert_array_equal(card.connected_components(),
                                  cpu.connected_components())
    np.testing.assert_array_equal(card.bfs_levels([0, 9]),
                                  cpu.bfs_levels([0, 9]))
    np.testing.assert_array_equal(card.sssp(3), cpu.sssp(3))
    labels = rng.integers(0, 100, 4096)
    np.testing.assert_array_equal(card.label_propagation(labels),
                                  cpu.label_propagation(labels))
    np.testing.assert_array_equal(card.jaccard_similarity(),
                                  cpu.jaccard_similarity())
    small = Graph.from_edges(e[:3000] % 512, num_vertices=512,
                             device=cuda_device)
    small_cpu = Graph.from_edges(e[:3000] % 512, num_vertices=512,
                                 device="cpu")
    np.testing.assert_array_equal(small.all_pairs_distances(),
                                  small_cpu.all_pairs_distances())
    np.testing.assert_allclose(card.pagerank(num_iterations=10),
                               cpu.pagerank(num_iterations=10), rtol=1e-5)
    for a, b in zip(card.hits(10), cpu.hits(10)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(card.adamic_adar(), cpu.adamic_adar(),
                               rtol=1e-5, atol=1e-6)
    assert sc.ordered_fold.launches > before


def test_graph_mesh_on_the_card_equals_single(cuda_device):
    """Four edge shards on one card: min combines equal the single device
    exactly; at one shard, every combine bit for bit."""
    from flink_tpu_torch.graph_lib import Graph
    from flink_tpu_torch.parallel.mesh import make_mesh
    e = _rmat_edges(11, 8, 4)
    g = Graph.from_edges(e, num_vertices=2048, device=cuda_device)
    for d in (1, 4):
        mesh = make_mesh(devices=[cuda_device] * d)
        np.testing.assert_array_equal(g.bfs_levels(0, mesh=mesh),
                                      g.bfs_levels(0))
        np.testing.assert_allclose(g.pagerank(num_iterations=10, mesh=mesh),
                                   g.pagerank(num_iterations=10),
                                   rtol=1e-5)
    one = make_mesh(devices=[cuda_device])
    init = np.random.default_rng(2).random(2048).astype(np.float32)

    def msg(v, _w):
        return v * 0.5

    def update(v, c):
        return v * 0.25 + c

    np.testing.assert_array_equal(
        g.scatter_gather(init, msg, "sum", update, 4, mesh=one),
        g.scatter_gather(init, msg, "sum", update, 4))


# ---------------------------------------------------------------------------
# object keys, the local job path, vector leaves on the mesh
# ---------------------------------------------------------------------------

def _word_batches(n_batches=8, n=40960, vocab=30000, seed=11):
    """WordCount's shape, small: Zipf(1.3) words, f32 ones."""
    rng = np.random.default_rng(seed)
    words = np.asarray([f"w{i:05d}" for i in range(vocab)], object)
    return [(words[rng.zipf(1.3, n) % vocab], np.ones(n, np.float32),
             i * 1000 + np.sort(rng.integers(0, 1000, n)).astype(np.int64))
            for i in range(n_batches)]


@pytest.mark.parametrize("tier", ["host", "device"])
def test_string_key_operator_on_the_card_equals_the_cpu(cuda_device, tier):
    """String keys (``ObjectKeyIndex``, the numpy mirror, no device probe):
    the window operator on the card fires the CPU's rows bit for bit, and
    its fold launches ``scatter_fold``; ``probe`` stays at 0."""
    from flink_tpu_torch.state.keyindex import ObjectKeyIndex
    batches = _word_batches()
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        op = WindowAggOperator(
            TumblingEventTimeWindows.of(5000), SumAggregator(torch.float32),
            key_column="k", value_column="v", emit_tier=tier,
            snapshot_source="mirror" if tier == "host" else "device",
            device_sync="scatter", device_probe="on", superbatch=1,
            device=dev)
        before = (sc.ordered_fold_counts.launches, dk.probe.launches)
        out = []
        for keys, vals, ts in batches:
            out += op.process_batch(RecordBatch({"k": keys, "v": vals},
                                                timestamps=ts))
            out += op.process_watermark(Watermark(int(ts.max()) - 1))
        out += op.end_input()
        assert isinstance(op.key_index, ObjectKeyIndex)
        runs.append(([(list(b.column("k")),
                       np.asarray(b.column("result")).tobytes())
                      for b in out],
                     sc.ordered_fold_counts.launches - before[0],
                     dk.probe.launches - before[1]))
    (g, gl, gp), (c, cl, cp) = runs
    assert g == c and g
    assert gl == len(batches) and cl == 0 and gp == cp == 0


def test_datastream_job_on_the_card_equals_the_cpu(cuda_device):
    """A string-keyed window job through the DataStream API on
    ``LocalExecutor`` (the sum of each word's timestamps a window, in f64):
    the card's rows equal the CPU's, and the card's fold launched
    ``scatter_fold``."""
    from flink_tpu_torch.datastream import StreamExecutionEnvironment
    keys, _, ts = _word_batches(n_batches=1, n=20000)[0]
    rows = {}
    for dev in (cuda_device, "cpu"):
        env = StreamExecutionEnvironment(device=dev)
        before = sc.ordered_fold_counts.launches
        rows[str(dev)] = (
            env.from_collection(columns={"word": keys, "t": ts * 5},
                                batch_size=4096)
            .assign_timestamps_and_watermarks(0, timestamp_column="t")
            .key_by("word").window(TumblingEventTimeWindows.of(5000))
            .sum("t", dtype=torch.float64)
            .execute_and_collect(),
            sc.ordered_fold_counts.launches - before)
    (g, gl), (c, cl) = rows["cuda"], rows["cpu"]
    assert g == c and len(g) > 1000 and gl > 0 and cl == 0


def _vector_stats():
    """An aggregate with non-scalar leaves (port only): per session the
    3-vector sum ``(v, v*v, 1)`` and the 2-vector min and max of
    ``(v, -v)``."""
    from flink_tpu_torch.core.functions import AggregateFunction

    class VectorStats(AggregateFunction):
        def identity(self):
            return {"s": torch.zeros(3),
                    "lo": torch.full((2,), float("inf")),
                    "hi": torch.full((2,), float("-inf"))}

        def lift(self, values):
            v = torch.as_tensor(values, dtype=torch.float32)
            pair = torch.stack([v, -v], 1)
            return {"s": torch.stack([v, v * v, torch.ones_like(v)], 1),
                    "lo": pair, "hi": pair}

        def combine(self, a, b):
            return {"s": a["s"] + b["s"],
                    "lo": torch.minimum(a["lo"], b["lo"]),
                    "hi": torch.maximum(a["hi"], b["hi"])}

        def get_result(self, acc):
            return acc["s"][..., 0] + acc["lo"][..., 0] + acc["hi"][..., 1]

        def scatter_kinds(self):
            return {"s": "add", "lo": "min", "hi": "max"}

    return VectorStats()


def test_mesh_vector_leaves_on_four_blocks_of_one_card_equal_the_cpu(
        cuda_device):
    """The mesh session fold's vector leaves over ``[cuda] * 4``: fires and
    snapshots bit for bit against ``["cpu"] * 4``; the sum leaf's cells
    fold through ``ordered_fold`` (``scatter_fold``) on the card."""
    from flink_tpu_torch.core.functions import RuntimeContext
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.mesh_runtime import \
        MeshSessionWindowOperator
    from flink_tpu_torch.windowing.assigners import EventTimeSessionWindows
    batches = _session_batches()
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        op = MeshSessionWindowOperator(
            EventTimeSessionWindows(300), _vector_stats(),
            key_column="k", value_column="v",
            mesh=make_mesh(devices=[dev] * 4))
        op.open(RuntimeContext())
        before = sc.ordered_fold.launches
        fired = _drive_elements(op, batches[:4], end=False)
        snap = op.snapshot_state()
        fired += _drive_elements(op, batches[4:])
        runs.append((fired, snap, sc.ordered_fold.launches - before))
    (gf, gs, gl), (cf, cs, cl) = runs
    assert gf == cf and gf
    for a, b in zip(gs["acc"], cs["acc"], strict=True):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert gl == 4 * len(batches) and cl == 0


def _late_stream(n_batches=8, B=4096, seed=41):
    """Batches with per-batch watermarks; from batch 3 on every other batch
    moves 1/8 of its rows beyond the lateness and 1/16 within it."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        k = rng.integers(0, 3000, B).astype(np.int64)
        v = rng.random(B).astype(np.float32)
        ts = i * 500 + np.sort(rng.integers(0, 500, B)).astype(np.int64)
        if i >= 3 and i % 2 == 1:
            ts[: B // 8] -= 2500
            ts[B // 8: B // 8 + B // 16] -= 600
        out.append((k, v, ts))
    return out


def _late_views(out):
    views = []
    for e in out:
        if hasattr(e, "tag"):
            b = e.batch
            views.append(("late", e.tag, np.asarray(b.column("k")).tobytes(),
                          np.asarray(b.column("v")).tobytes(),
                          np.asarray(b.timestamps).tobytes()))
        elif len(e):
            views.append(("fire", np.asarray(e.column("k")).tobytes(),
                          np.asarray(e.column("result")).tobytes()))
    return views


@pytest.mark.parametrize("async_fire", [False, True])
def test_late_side_output_on_the_card_equals_the_cpu(cuda_device,
                                                     async_fire):
    """The device tier with ``late_output_tag`` on the card: every fire and
    side output, in order, equals the CPU's; nothing is counted dropped."""
    from flink_tpu_torch.core.functions import RuntimeContext
    runs = []
    for dev in (cuda_device, "cpu"):
        op = WindowAggOperator(
            TumblingEventTimeWindows.of(1000), SumAggregator(),
            key_column="k", value_column="v", allowed_lateness_ms=700,
            late_output_tag="late", emit_tier="device",
            snapshot_source="device", device_sync="scatter",
            async_fire=async_fire, device=dev)
        op.open(RuntimeContext())
        before = sc.ordered_fold_counts.launches
        out = []
        for k, v, ts in _late_stream():
            out += op.process_batch(RecordBatch({"k": k, "v": v},
                                                timestamps=ts))
            out += op.process_watermark(Watermark(int(ts.max()) - 1))
        out += op.end_input()
        runs.append((_late_views(out), op.late_dropped,
                     sc.ordered_fold_counts.launches - before))
    (g, gd, gl), (c, cd, cl) = runs
    assert g == c and gd == cd == 0 and gl > 0 and cl == 0
    assert sum(v[0] == "late" for v in g) == 3


def test_cep_select_on_the_card_equals_the_cpu(cuda_device):
    """``CEP.pattern(keyed, pattern).select(fn, vectorized="on")`` through
    the DataStream API: the card's matches equal the CPU's."""
    from flink_tpu_torch.cep import CEP, Pattern
    from flink_tpu_torch.datastream import StreamExecutionEnvironment
    rng = np.random.default_rng(23)
    n = 20000
    cols = {"k": rng.integers(0, 500, n).astype(np.int64),
            "amount": rng.integers(1, 1000, n).astype(np.int64),
            "ts": np.sort(rng.integers(0, 100_000, n)).astype(np.int64)}
    pattern = (Pattern.begin("small")
               .where(lambda c: np.asarray(c["amount"]) < 20)
               .followed_by("large")
               .where(lambda c: np.asarray(c["amount"]) > 900)
               .within(5000))
    rows = []
    for dev in (cuda_device, "cpu"):
        env = StreamExecutionEnvironment(device=dev)
        ks = (env.from_collection(columns=cols, timestamp_column="ts",
                                  batch_size=4096)
              .assign_timestamps_and_watermarks(0, timestamp_column="ts")
              .key_by("k"))
        rows.append(CEP.pattern(ks, pattern).select(
            lambda m: {"k": m["small"][0]["k"],
                       "t0": m["small"][0]["ts"],
                       "t1": m["large"][0]["ts"]}, vectorized="on")
            .execute_and_collect())
    assert rows[0] == rows[1] and rows[0]


def test_env_mesh_on_four_blocks_of_one_card_equals_the_mesh_operator(
        cuda_device):
    """``StreamExecutionEnvironment(mesh=make_mesh(devices=[cuda] * 4))``
    routes the window sum to the mesh operator: its rows equal the mesh
    operator driven by hand over the same batches on the card."""
    from flink_tpu_torch.core.functions import RuntimeContext
    from flink_tpu_torch.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.mesh_runtime import MeshWindowAggOperator
    batches = _late_stream(n_batches=6, seed=3)
    batches = [(k, v, np.sort(ts)) for k, v, ts in batches]
    cols = {"k": np.concatenate([b[0] for b in batches]),
            "v": np.concatenate([b[1] for b in batches]),
            "t": np.concatenate([b[2] for b in batches])}
    env = StreamExecutionEnvironment(
        device=cuda_device, mesh=make_mesh(devices=[cuda_device] * 4))
    rows = (env.from_collection(columns=cols, batch_size=4096)
            .assign_timestamps_and_watermarks(0, timestamp_column="t")
            .key_by("k").window(TumblingEventTimeWindows.of(1000))
            .aggregate(SumAggregator(torch.float32), value_column="v")
            .execute_and_collect())
    op = MeshWindowAggOperator(
        TumblingEventTimeWindows.of(1000), SumAggregator(torch.float32),
        key_column="k", value_column="v",
        mesh=make_mesh(devices=[cuda_device] * 4))
    op.open(RuntimeContext())
    out = []
    wm = None
    for k, v, t in batches:
        out += op.process_batch(RecordBatch({"k": k, "v": v}, timestamps=t))
        wm = int(t.max())
        out += op.process_watermark(Watermark(wm))
    out += op.process_watermark(Watermark(2 ** 63 - 1))
    want = [r for b in out for r in b.to_rows()]
    got = [{c: x for c, x in r.items() if c != "__ts__"} for r in rows]
    key = lambda r: (r["window_start"], r["k"])  # noqa: E731
    assert sorted(got, key=key) == sorted(want, key=key) and got


def _dataset_batches(b):
    return [(k, np.asarray(v).dtype.str, np.asarray(v).tobytes())
            for k, v in b.columns.items()]


def test_dataset_join_on_the_card_equals_the_cpu(cuda_device, monkeypatch):
    """A DataSet inner join and grouped sum (single and two-column keys),
    materialized and streamed with a budget that sends the join out of core
    (grace buckets over the port's FTB files), through the device lane on
    the card against the same plan on the CPU: rows, order and bits."""
    from flink_tpu_torch.dataset import ExecutionEnvironment

    monkeypatch.setenv("FLINK_TPU_DEVICE_JOIN", "1")
    monkeypatch.setenv("FLINK_TPU_BATCH_MEMORY_ROWS", "20000")
    rng = np.random.default_rng(45)
    cols_l = {"k": rng.integers(0, 4000, 30_000).astype(np.int64),
              "j": rng.integers(0, 3, 30_000).astype(np.int64),
              "v": rng.standard_normal(30_000)}
    cols_r = {"k": rng.integers(0, 5000, 8_000).astype(np.int64),
              "j": rng.integers(0, 3, 8_000).astype(np.int64),
              "w": rng.standard_normal(8_000)}

    def run(device):
        env = ExecutionEnvironment(device=device)
        l, r = env.from_columns(cols_l), env.from_columns(cols_r)
        out = []
        for keys in (("k",), ("k", "j")):
            j = l.join(r).where(*keys).equal_to(*keys).apply()
            g = j.group_by("k").sum("v")
            out += [_dataset_batches(j.collect_batch()),
                    [_dataset_batches(b) for b in j.stream_batches()],
                    _dataset_batches(g.collect_batch())]
        return out

    assert run(cuda_device) == run("cpu")


def test_graph_as_dataset_on_the_card_equals_the_cpu(cuda_device):
    """``as_dataset`` of a graph on the card: JAX's columns, downloaded once,
    equal to the CPU graph's, in an environment on the card."""
    from flink_tpu_torch.graph_lib import Graph

    rng = np.random.default_rng(46)
    src = rng.integers(0, 500, 4000)
    dst = rng.integers(0, 500, 4000)
    w = rng.random(4000).astype(np.float32)
    for weights in (None, w):
        gc = Graph(500, src, dst, weights, device=cuda_device).undirected()
        gh = Graph(500, src, dst, weights, device="cpu").undirected()
        dc, dh = gc.as_dataset(), gh.as_dataset()
        assert dc.env.device == gc.device and dc.env.device.type == "cuda"
        assert _dataset_batches(dc.collect_batch()) == \
            _dataset_batches(dh.collect_batch())


def _incremental_cuts(device, batches):
    """The device tier with incremental state on: a cut every second batch
    under the incremental scope, every one confirmed but the third."""
    from flink_tpu_torch.operators.base import snapshot_scope

    op = WindowAggOperator(TumblingEventTimeWindows.of(1000),
                           SumAggregator(torch.float32), key_column="k",
                           value_column="v", emit_tier="device",
                           snapshot_source="device", device_sync="scatter",
                           device_probe="off", device=device)
    op.incremental_state = True
    cuts = []
    for i, (k, v, ts) in enumerate(batches):
        op.process_batch(RecordBatch({"k": k, "v": v}, timestamps=ts))
        op.process_watermark(Watermark(int(ts.max()) - 1200))
        if i % 2 == 1:
            with snapshot_scope(i, incremental=True):
                cuts.append(op.snapshot_state())
            if i != 5:
                op.notify_checkpoint_complete(i)
    return cuts, op


def test_incremental_cut_on_the_card_equals_the_cpu(cuda_device):
    """The device tier's ``window_delta`` increments (one gather of the
    dirty rows x dirty panes on the card) equal the CPU's bit for bit, and
    their chain resolves to the same full snapshot."""
    from flink_tpu_torch.runtime.checkpoint import delta

    rng = np.random.default_rng(47)
    batches = [(rng.integers(0, 3000 // (4 if i else 1), 4000),
                rng.random(4000).astype(np.float32),
                i * 300 + np.sort(rng.integers(0, 300, 4000)))
               for i in range(12)]
    got, gop = _incremental_cuts(cuda_device, batches)
    want, wop = _incremental_cuts("cpu", batches)
    assert "window_delta" in [c.get("kind") for c in got]
    assert [c.get("kind") for c in got] == [c.get("kind") for c in want]

    def same(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            return all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            assert len(a) == len(b)
            return all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
            return True
        assert a == b
        return True

    assert same(got, want)
    assert same(delta.resolve_chain(got), delta.resolve_chain(want))
    assert gop.phase_bytes["d2h_page_out"] == wop.phase_bytes["d2h_page_out"]


def test_minicluster_job_on_the_card_equals_the_cpu(cuda_device):
    """A parallelism-2 windowed job with incremental checkpoints on the
    MiniCluster: its operators run on the card (the device tier pinned) and
    its rows equal the CPU twin's bit for bit."""
    import tempfile

    from flink_tpu_torch.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.runtime.checkpoint.incremental import \
        IncrementalCheckpointStorage

    rng = np.random.default_rng(48)
    n = 40000
    cols = {"k": rng.integers(0, 5000, n).astype(np.int64),
            "v": rng.random(n).astype(np.float32),
            "t": np.sort(rng.integers(0, 20000, n)).astype(np.int64)}

    def run(device):
        env = StreamExecutionEnvironment(device=device)
        env.set_parallelism(2)
        sink = (env.from_collection(columns=cols, timestamp_column="t",
                                    batch_size=2000)
                .assign_timestamps_and_watermarks(0, timestamp_column="t")
                .key_by("k").window(TumblingEventTimeWindows.of(5000))
                .aggregate(SumAggregator(torch.float32), value_column="v",
                           emit_tier="device", device_probe="off")
                .collect())
        with tempfile.TemporaryDirectory() as d:
            res = env.execute_cluster(
                checkpoint_interval_ms=20, incremental=True, timeout_s=120,
                storage=IncrementalCheckpointStorage(d))
        assert res.state == "FINISHED"
        devices = {str(m.device) for t in env._last_cluster._tasks
                   for m in getattr(t.operator, "operators", [t.operator])
                   if isinstance(m, WindowAggOperator)}
        return sorted((r["k"], r["window_start"],
                       np.float32(r["result"]).tobytes())
                      for r in sink.rows()), devices

    got, gdev = run(cuda_device)
    want, wdev = run("cpu")
    assert gdev and all(d.startswith("cuda") for d in gdev)
    assert wdev == {"cpu"}
    assert got == want


PROCESS_JOB = '''
"""A keyed tumbling f32 sum in one source split (each key folds in record
order), the window operators pinned to the device tier; a map slows each
batch so checkpoints complete while the stream runs."""
import time

import numpy as np
import torch

from flink_tpu_torch.connectors.sources import CollectionSource, SourceSplit
from flink_tpu_torch.core.functions import SumAggregator
from flink_tpu_torch.datastream import StreamExecutionEnvironment
from flink_tpu_torch.operators.window_agg import WindowAggOperator
from flink_tpu_torch.windowing import TumblingEventTimeWindows

PINS = dict(emit_tier="device", snapshot_source="device",
            device_sync="scatter", superbatch=1)
_init = WindowAggOperator.__init__


def _pinned(self, *args, **kwargs):
    _init(self, *args, **{**kwargs, **PINS})


WindowAggOperator.__init__ = _pinned


class OneSplit(CollectionSource):
    def create_splits(self, parallelism):
        return [SourceSplit(self, 0, 1)]


def _slow(cols):
    time.sleep(0.02)
    return cols


def build():
    rng = np.random.default_rng(21)
    n = 60 * 4096
    cols = {"k": rng.integers(0, 20000, n).astype(np.int64),
            "v": rng.random(n).astype(np.float32),
            "ts": np.repeat(np.arange(60) * 500, 4096).astype(np.int64)}
    env = StreamExecutionEnvironment()
    env.set_parallelism(2)
    (env.from_source(OneSplit(columns=cols, batch_size=4096), "source")
        .map(_slow)
        .assign_timestamps_and_watermarks(0, timestamp_column="ts")
        .key_by("k")
        .window(TumblingEventTimeWindows.of(5000))
        .aggregate(SumAggregator(torch.float32), value_column="v")
        .collect())
    return env.get_stream_graph("process-job")
'''


def _process_job_rows(tmp_path, device, kill):
    """Run ``PROCESS_JOB`` on a 2-worker process cluster on ``device``,
    SIGKILLing the worker of window subtask 0 after two completed
    checkpoints when ``kill``; returns (rows sorted, the result, the
    cluster)."""
    import os
    import signal
    import sys
    import threading
    import time

    from flink_tpu_torch.cluster.distributed import (ProcessCluster,
                                                     assign_subtasks,
                                                     build_plan,
                                                     subtask_counts_of)
    (tmp_path / "process_job_mod.py").write_text(PROCESS_JOB)
    sys.path.insert(0, str(tmp_path))
    try:
        plan = build_plan("process_job_mod:build")
        counts, _ = subtask_counts_of(plan)
        window = [v.uid for v in plan.vertices if not v.is_source
                  and "window" in v.uid]
        victim = assign_subtasks(plan, counts, 2)[(window[0], 0)]
        pc = ProcessCluster("process_job_mod:build", n_workers=2,
                            checkpoint_interval_ms=20, restart_attempts=1,
                            extra_sys_path=(str(tmp_path),), device=device)
        killed = {}

        def chaos():
            end = time.monotonic() + 120
            while time.monotonic() < end and kill:
                procs = getattr(pc, "_procs", None)
                if len(pc._completed_ids) >= 2 and procs \
                        and all(p.poll() is None for p in procs):
                    killed["pid"] = procs[victim].pid
                    os.kill(procs[victim].pid, signal.SIGKILL)
                    return
                time.sleep(0.002)

        th = threading.Thread(target=chaos)
        th.start()
        res = pc.run(timeout_s=300)
        th.join()
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("process_job_mod", None)
    assert res["state"] == "FINISHED", res["error"]
    if kill:
        assert "pid" in killed and res["recoveries"] == 1, res["recoveries"]
    rows = sorted((r["window_start"], r["k"],
                   np.float32(r["result"]).view(np.uint32).item())
                  for r in res["rows"])
    return rows, res, pc


def test_process_cluster_job_on_the_card_equals_the_cpu(cuda_device,
                                                        tmp_path):
    """A 2-worker ``ProcessCluster`` keyed window job on the card (the
    device tier: its folds launch ``scatter_fold``), a worker SIGKILLed
    once and respawned on the card, equals its CPU twin (the same job on
    ``--device cpu`` workers, unfaulted) bit for bit; no worker process
    outlives either job."""
    (tmp_path / "card").mkdir()
    (tmp_path / "cpu").mkdir()
    got, res, pc = _process_job_rows(tmp_path / "card", cuda_device, True)
    want, _, cpu = _process_job_rows(tmp_path / "cpu", "cpu", False)
    assert got == want
    assert len(got) > 20000
    for cluster in (pc, cpu):
        assert all(p.poll() is not None for p in cluster._procs)
    assert "--device cuda" in " ".join(pc._procs[0].args)


def _served_run(device):
    """The small seeded stream through a device-tier operator with
    ``queryable=`` and the span journal installed: after each call that
    fires, the view's answers for every key of the newest fire batch, and
    the run's ``hot_stage`` span sums and ``phase_ns``."""
    from flink_tpu_torch.observability import tracing
    journal = tracing.SpanJournal(1 << 16)
    tracing.install(journal)
    try:
        op = _device_tier(device, queryable="sums")
        view = op.queryable_view()
        answers = []

        def served(out):
            fired = [b for b in out if "result" in getattr(b, "columns", {})]
            if fired:
                keys = np.asarray(fired[-1].column("k"))
                found, cols, tags = view.lookup_batch_columnar(keys)
                assert found.all()
                assert cols["result"].tobytes() == \
                    np.asarray(fired[-1].column("result")).tobytes()
                answers.append((keys.tobytes(), cols["result"].tobytes(),
                                tags))

        for _, batch, ts in _small_batches():
            served(op.process_batch(batch))
            served(op.process_watermark(Watermark(int(ts.max()) - 1)))
        served(op.end_input())
    finally:
        tracing.uninstall()
    sums = {}
    for ph, _ts, dur, name, cat, _tid, _args in journal.spans():
        if cat == "hot_stage":
            sums[name] = sums.get(name, 0) + dur
    assert journal.dropped == 0
    return answers, sums, dict(op.phase_ns)


def test_live_view_on_the_card_equals_the_cpu(cuda_device):
    """On the device tier, the live view answers every key of each fire
    with that fire's row, bit for bit the CPU twin's answers; with the
    journal on, each phase's ``hot_stage`` spans sum exactly to its
    ``phase_ns``."""
    got, gsums, gphase = _served_run(cuda_device)
    want, wsums, wphase = _served_run("cpu")
    assert len(got) == len(want) > 0
    assert got == want
    assert gsums == gphase and wsums == wphase
    assert {"probe", "device_dispatch", "fire"} <= set(gphase)

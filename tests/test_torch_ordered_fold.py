"""The ordered fold on the CPU: ``ordered_fold_counts_multi`` and its plain
version, the tile plan of ``csrc/scatter_fold.cu``, how the wrapper packs a
call's planes into launches, and the probe lanes' folds.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``); on
the CPU ``ordered_fold_counts_multi`` is ``scatter_fold_counts_multi``, a
loop of ``scatter_fold_counts``, which these tests hold to the JAX package's
``flink_tpu.ops.scatter.scatter_fold_counts`` bit for bit.  The probe-on
host tier (scatter and deferred sync, numpy and C mirror) is held to the
JAX operator's fires, snapshots and counters bit for bit, and a counter
shows that its folds go through the ordered fold.
"""

import contextlib

import numpy as np
import pytest

import jax
import jax.experimental
import jax.numpy as jnp
import torch

from flink_tpu.core import functions as jfn
from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.core.batch import Watermark as JaxWatermark
from flink_tpu.operators.window_agg import WindowAggOperator as JaxOp
from flink_tpu.ops import scatter as jsc
from flink_tpu.windowing import assigners as jwin
from flink_tpu_torch.core import functions as pfn
from flink_tpu_torch.core.batch import RecordBatch, Watermark
from flink_tpu_torch.interop import snapshot_from_jax
from flink_tpu_torch.operators import window_agg as wa
from flink_tpu_torch.ops import scatter as tsc
from flink_tpu_torch.state import device_keyindex as tdk
from flink_tpu_torch.windowing import assigners as pwin


@contextlib.contextmanager
def _jax_x64():
    """The reference's probe lane imports ``jax.experimental.enable_x64``,
    which jax 0.9 moved to ``jax.enable_x64``: restore the old name for the
    duration of a JAX run."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64",
                       lambda new_val=True: jax.enable_x64(new_val),
                       raising=False)
        yield


# ---------------------------------------------------------------------------
# the multi-plane fold's plain version
# ---------------------------------------------------------------------------

def _multi_inputs(seed, ids_dtype, case, n_cells=96, n=700):
    """Ids (repeated; the dropped id n_cells on some rows, or all), one f32
    value column, and the probe lane's two groups: an f32 replica and an
    f64 delta ring, each with its int32 counts."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_cells + 1, n).astype(ids_dtype)
    ids[:40] = n_cells
    if case == "all_dropped":
        ids[:] = n_cells
    vals = (rng.standard_normal(n) * 10).astype(np.float32)
    replica = (rng.standard_normal(n_cells) * 3).astype(np.float32)
    delta = rng.standard_normal(n_cells) * 3
    counts = [rng.integers(0, 5, n_cells).astype(np.int32) for _ in range(2)]
    return ids, vals, replica, delta, counts


def _groups(vals, replica, delta, counts):
    lifted = (torch.from_numpy(vals),)
    return [((torch.from_numpy(replica.copy()),),
             torch.from_numpy(counts[0].copy()), lifted),
            ((torch.from_numpy(delta.copy()),),
             torch.from_numpy(counts[1].copy()), lifted)]


@pytest.mark.parametrize("case", ["some_dropped", "all_dropped"])
@pytest.mark.parametrize("ids_dtype", [np.int32, np.int64])
def test_multi_plain_version_is_a_loop_of_single_folds(ids_dtype, case):
    """``scatter_fold_counts_multi`` (and ``ordered_fold_counts_multi`` on
    the CPU, which is it) equals one ``scatter_fold_counts`` per group bit
    for bit, in place, with no launch counted."""
    ids, vals, replica, delta, counts = _multi_inputs(3, ids_dtype, case)
    t_ids = torch.from_numpy(ids)
    want = [tsc.scatter_fold_counts(leaves, cnt, t_ids, lifted, ("add",))
            for leaves, cnt, lifted in _groups(vals, replica, delta, counts)]
    for fold in (tsc.scatter_fold_counts_multi, tsc.ordered_fold_counts_multi):
        groups = _groups(vals, replica, delta, counts)
        before = tsc.ordered_fold_counts_multi.launches
        got = fold(groups, t_ids, ("add",))
        assert tsc.ordered_fold_counts_multi.launches == before
        assert len(got) == 2
        for (gl, gc), (wl, wc), (leaves, cnt, _) in zip(got, want, groups):
            assert gc is cnt and gl[0] is leaves[0]
            assert gc.numpy().tobytes() == wc.numpy().tobytes()
            assert gl[0].dtype == wl[0].dtype
            assert gl[0].numpy().tobytes() == wl[0].numpy().tobytes()
    if case == "all_dropped":
        assert np.array_equal(want[0][1].numpy(), counts[0])
        assert np.array_equal(want[1][0][0].numpy(), delta)


@pytest.mark.parametrize("case", ["some_dropped", "all_dropped"])
@pytest.mark.parametrize("ids_dtype", [np.int32, np.int64])
def test_multi_fold_matches_jax_on_the_cpu(ids_dtype, case):
    """The same numpy inputs through JAX's ``scatter_fold_counts`` (x64 on,
    so the f64 delta ring stays f64) and the port's multi-plane fold: both
    groups bit for bit."""
    ids, vals, replica, delta, counts = _multi_inputs(9, ids_dtype, case)
    got = tsc.ordered_fold_counts_multi(
        _groups(vals, replica, delta, counts), torch.from_numpy(ids),
        ("add",))
    with jax.enable_x64(True):
        for (gl, gc), plane, cnt in zip(got, (replica, delta), counts):
            (wl,), wc = jsc.scatter_fold_counts(
                (jnp.asarray(plane),), jnp.asarray(cnt), jnp.asarray(ids),
                (jnp.asarray(vals),), ("add",))
            assert np.asarray(wl).dtype == plane.dtype
            assert gl[0].numpy().tobytes() == np.asarray(wl).tobytes()
            assert np.array_equal(gc.numpy(), np.asarray(wc))


# ---------------------------------------------------------------------------
# the tile plan and the packing of a call into launches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_rows,n_cells", [
    (0, 0), (1, 1), (100, 255), (5000, 4096), (70000, (1 << 14) * 16),
    (70000, (1 << 14) * 16 + 12345), (1 << 18, 1 << 24),
    (2_093_056, 1 << 24), (10, (1 << 24) + 1), (10, 2 ** 31 - 1)])
def test_scatter_plan_covers_every_cell_once(n_rows, n_cells):
    """Tiles of ``2^tile_bits`` cells (at least 2, the last maybe short)
    cover the cells once, at most ``SCATTER_MAX_TILES`` of them; about
    ``SCATTER_CHUNK / 2`` rows a tile once the batch is large enough;
    blocks of ``SCATTER_PART_ROWS`` cover the rows; ``fold_plan``, which
    ``probe_fold`` takes, keeps its own results."""
    bits, tiles, blocks = tsc.scatter_plan(n_rows, n_cells)
    assert 1 <= bits <= 31
    assert tiles <= tsc.SCATTER_MAX_TILES
    assert (tiles - 1) << bits < n_cells <= tiles << bits or tiles == 0
    assert (blocks - 1) * tsc.SCATTER_PART_ROWS < n_rows \
        <= blocks * tsc.SCATTER_PART_ROWS or blocks == n_rows == 0
    if n_cells >= 1 << 20 and tsc.SCATTER_MIN_TILES * tsc.SCATTER_CHUNK \
            <= 2 * n_rows <= tsc.SCATTER_MAX_TILES * tsc.SCATTER_CHUNK:
        rows_a_tile = n_rows / tiles
        assert tsc.SCATTER_CHUNK / 4 <= rows_a_tile <= tsc.SCATTER_CHUNK
    if (n_rows, n_cells) == (1 << 18, 1 << 24):
        assert (bits, tiles, blocks) == (17, 128, 128)
    if n_cells == 1 << 24 and n_rows == 2_093_056:
        assert tdk.fold_plan(n_rows, n_cells) == (14, 1024, 511)


def _tensors(*dtypes, n=8):
    return [torch.zeros(n, dtype=d) for d in dtypes]


def test_one_launch_folds_every_plane_and_count_of_the_probe_lane():
    """The probe lane's replica (f32) and delta ring (f64) fold the same
    lifted f32 column: one launch, one source, the f64 plane widening it,
    both count planes."""
    rep, delta, lifted = _tensors(torch.float32, torch.float64,
                                  torch.float32)
    c1, c2 = _tensors(torch.int32, torch.int32)
    launches = tsc._fold_launches([((rep,), c1, (lifted,)),
                                   ((delta,), c2, (lifted,))], ("add",))
    ((sources, planes, counts),) = launches
    assert len(sources) == 1 and sources[0] is lifted
    assert [(p is q, i) for (p, i), q in zip(planes, (rep, delta))] \
        == [(True, 0), (True, 0)]
    assert counts[0] is c1 and counts[1] is c2


def test_launch_packing_casts_what_the_kernel_cannot_widen():
    """A tree with no ``add`` leaf is one launch of counts alone (no column
    of ones); an f32 column into an i64 plane is cast first (the plain
    version's cast); more than eight planes take a second launch."""
    mx, lifted = _tensors(torch.float32, torch.float32)
    cnt = torch.zeros(8, dtype=torch.int32)
    ((src, planes, counts),) = tsc._fold_launches(
        [((mx,), cnt, (lifted,))], ("max",))
    assert src == [] and planes == [] and counts == [cnt]
    (i64,) = _tensors(torch.int64)
    ((src, planes, _),) = tsc._fold_launches([((i64,), cnt, (lifted,))],
                                             ("add",))
    assert src[0].dtype == torch.int64 and planes[0][0] is i64
    leaves = _tensors(*[torch.float32] * 9)
    cols = _tensors(*[torch.float32] * 9)
    packed = tsc._fold_launches([(tuple(leaves), cnt, tuple(cols))],
                                ("add",) * 9)
    assert [len(p) for _, p, _ in packed] == [8, 1]
    assert [len(c) for _, _, c in packed] == [0, 1]
    assert sum(len(s) for s, _, _ in packed) == 9


# ---------------------------------------------------------------------------
# the probe lanes: ordered folds, and still JAX's bits
# ---------------------------------------------------------------------------

def _batches(n_batches=6, nk=1200, b=3000, seed=17):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        keys = rng.integers(0, nk + 150 * i, b).astype(np.int64)
        vals = rng.random(b).astype(np.float32)
        ts = i * 50 + np.sort(rng.integers(0, 50, b)).astype(np.int64)
        out.append((keys, vals, ts))
    return out


BATCHES = _batches()
SNAP_AT = 3


def _run(side, agg="sum", **lane):
    native = lane.get("native_emit", False)
    common = dict(key_column="k", value_column="v", emit_tier="host",
                  snapshot_source="mirror", device_probe="on",
                  native_shards=2 if native else 0, pipeline_depth=0,
                  initial_key_capacity=1 << 10, **lane)
    if side == "jax":
        a = {"sum": lambda: jfn.SumAggregator(jnp.float32),
             "avg": lambda: jfn.AvgAggregator(jnp.float32)}[agg]()
        ctx, RB, WM = _jax_x64, JaxBatch, JaxWatermark
        with ctx():
            op = JaxOp(jwin.TumblingEventTimeWindows.of(100), a, **common)
            op.open(jfn.RuntimeContext())
    else:
        a = {"sum": pfn.SumAggregator, "avg": pfn.AvgAggregator}[agg]()
        ctx, RB, WM = contextlib.nullcontext, RecordBatch, Watermark
        op = wa.WindowAggOperator(pwin.TumblingEventTimeWindows.of(100), a,
                                  device="cpu", **common)
        op.open(pfn.RuntimeContext())
    out, snap = [], None
    with ctx():
        for i, (keys, vals, ts) in enumerate(BATCHES):
            out += op.process_batch(RB({"k": keys, "v": vals},
                                       timestamps=ts))
            out += op.process_watermark(WM(int(ts.max()) - 1))
            if i == SNAP_AT:
                out += op.prepare_snapshot_pre_barrier()
                snap = op.snapshot_state()
        out += op.end_input()
        stats = op.device_probe_stats()
    if side == "jax":
        snap = snapshot_from_jax(snap)
    fires = [(int(np.asarray(b.column("window_start"))[0]),
              np.asarray(b.column("k")).tobytes(),
              np.asarray(b.column("result")).tobytes()) for b in out]
    snap_bytes = (np.asarray(snap["panes"]).tobytes(),
                  np.asarray(snap["counts"]).tobytes(),
                  tuple(np.asarray(l).tobytes() for l in snap["leaves"]),
                  np.asarray(snap["key_index"]["reverse"]).tobytes())
    counters = (op.late_dropped, op.watermark, op.last_fired_window,
                stats["probe_hits"], stats["probe_misses"])
    return fires, snap_bytes, counters


LANES = {
    "scatter": dict(device_sync="scatter", superbatch=1),
    "scatter-native": dict(device_sync="scatter", superbatch=1,
                           native_emit=True),
    "deferred": dict(device_sync="deferred", superbatch=1),
    "deferred-native": dict(device_sync="deferred", superbatch=1,
                            native_emit=True),
}


@pytest.mark.parametrize("lane", sorted(LANES))
def test_probe_on_host_tier_equals_jax_bit_for_bit(lane):
    """Scatter and deferred sync, numpy and C mirror, one batch at a time:
    the port's fires, mid-run snapshot and counters equal the JAX
    operator's bit for bit."""
    got = _run("port", **LANES[lane])
    want = _run("jax", **LANES[lane])
    assert len(got[0]) == len(want[0]) > 0
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2] and got[2][3] > 0


@pytest.mark.parametrize("lane,agg,fold", [
    ("scatter", "sum", "multi"), ("scatter-native", "sum", "multi"),
    ("deferred", "sum", "single"),
    # the fused lane's fallback: not a single add leaf, so no probe_fold
    ("deferred-sb4-avg", "avg", "single")])
def test_probe_lanes_fold_through_the_ordered_fold(monkeypatch, lane, agg,
                                                   fold):
    """``_probed_update_step`` folds its replica and delta ring in one
    ``ordered_fold_counts_multi`` call over the same ids, and
    ``_probed_delta_step`` (also the fused lane's fallback) through
    ``ordered_fold_counts``; the operator no longer reaches
    ``scatter_fold_counts`` itself."""
    assert not hasattr(wa, "scatter_fold_counts")
    calls = {"single": [], "multi": []}
    single, multi = wa.ordered_fold_counts, wa.ordered_fold_counts_multi

    def count_single(leaves, counts, ids, lifted, kinds):
        calls["single"].append(int(counts.shape[0]))
        return single(leaves, counts, ids, lifted, kinds)

    def count_multi(groups, ids, kinds):
        calls["multi"].append(len(groups))
        return multi(groups, ids, kinds)

    monkeypatch.setattr(wa, "ordered_fold_counts", count_single)
    monkeypatch.setattr(wa, "ordered_fold_counts_multi", count_multi)
    kw = (dict(device_sync="deferred", superbatch=4) if lane.endswith("avg")
          else LANES[lane])
    _, _, counters = _run("port", agg=agg, **kw)
    assert counters[3] > 0                      # the probe hit
    if fold == "multi":
        assert calls["multi"] and set(calls["multi"]) == {2}
    else:
        assert calls["single"] and not calls["multi"]

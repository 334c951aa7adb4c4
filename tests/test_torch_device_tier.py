"""Port parity for slice 5: the device emit tier of ``flink_tpu_torch``'s
``WindowAggOperator`` (``emit_tier="device"``, ``snapshot_source="device"``,
``async_fire``) against the JAX operator's device tier on the CPU.

Both sides fold every batch into the ``[K, P]`` replica in row order (XLA's
CPU scatter; the port's plain version of the ordered fold, CPU
``index_add_``), mark a boolean host emit mirror, gather a fire's rows,
combine the window's panes in the same pairwise order and download only the
results.  So fires, snapshots and ``late_dropped`` are compared BIT FOR BIT.
The stream grows the key capacity and the pane ring, expires panes, drops
late records and re-fires windows within the allowed lateness.

One JAX run per (aggregate, window) is held against four port lanes:
superbatch 1 and 4, ``native_emit`` False and True.  JAX's device tier never
stages (its ``_fused_depth`` is 1 off the host tier) and always keys through
its C keydict; the port stages at superbatch 4 (one fold over the
concatenated batches adds each cell's rows in the same order) and keys
through the numpy ``KeyIndex`` or the C keydict, which number keys alike.

The JAX side runs under the ``_jax_x64`` shim of the other parity files.
Without x64 JAX stores an int64 accumulator leaf as int32; the port keeps
int64 (``test_int64_sum_values_match_jax`` compares values and states the
dtypes).  Both store the count as int32.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

import jax
import jax.experimental
import jax.numpy as jnp

from flink_tpu.core import functions as jfn
from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.core.batch import Watermark as JaxWatermark
from flink_tpu.ops import scatter as jsc
from flink_tpu.operators.window_agg import WindowAggOperator as JaxOp
from flink_tpu.windowing import assigners as jwin
from flink_tpu_torch.core import functions as pfn
from flink_tpu_torch.core.batch import RecordBatch, Watermark
from flink_tpu_torch.interop import snapshot_from_jax, snapshot_to_jax
from flink_tpu_torch.operators.window_agg import WindowAggOperator
from flink_tpu_torch.ops import scatter as tsc
from flink_tpu_torch.state.keyindex import KeyIndex, NativeKeyIndex
from flink_tpu_torch.windowing import assigners as pwin

DEVICE_TIER = dict(emit_tier="device", snapshot_source="device",
                   device_sync="scatter", pipeline_depth=0)
LANES = {"sb1": dict(superbatch=1, native_emit=False),
         "sb4": dict(superbatch=4, native_emit=False),
         "sb1-native": dict(superbatch=1, native_emit=True),
         "sb4-native": dict(superbatch=4, native_emit=True)}
SNAP_AT = 5
LATENESS = 150


@contextlib.contextmanager
def _jax_x64():
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64",
                       lambda new_val=True: jax.enable_x64(new_val),
                       raising=False)
        yield


#: (JAX aggregate, port aggregate), as in tests/test_torch_native_mirror.py
AGGS = {
    "sum": (lambda: jfn.SumAggregator(jnp.float32),
            lambda: pfn.SumAggregator()),
    "min": (lambda: jfn.MinAggregator(jnp.float32),
            lambda: pfn.MinAggregator()),
    "max": (lambda: jfn.MaxAggregator(jnp.float32),
            lambda: pfn.MaxAggregator()),
    "count": (lambda: jfn.CountAggregator(), lambda: pfn.CountAggregator()),
    "avg": (lambda: jfn.AvgAggregator(jnp.float32),
            lambda: pfn.AvgAggregator()),
    "tuple": (lambda: jfn.TupleAggregator(
                  {"s": ("v", jfn.SumAggregator(jnp.float32)),
                   "m": ("v", jfn.MaxAggregator(jnp.float32))}),
              lambda: pfn.TupleAggregator(
                  {"s": ("v", pfn.SumAggregator()),
                   "m": ("v", pfn.MaxAggregator())})),
}
WINDOWS = {"tumbling": None, "sliding": (300, 100)}


def _assigner(side, window):
    mod = jwin if side == "jax" else pwin
    if WINDOWS[window] is None:
        return mod.TumblingEventTimeWindows.of(100)
    return mod.SlidingEventTimeWindows.of(*WINDOWS[window])


def _make(side, agg="sum", window="tumbling", **kw):
    """An operator of either package; ``kw`` overrides the device tier's
    defaults (tiny initial key capacity and pane ring, so both grow)."""
    jagg, pagg = AGGS[agg]
    common = {**dict(key_column="k",
                     value_column=None if agg == "tuple" else "v",
                     allowed_lateness_ms=LATENESS, initial_key_capacity=64,
                     initial_panes=1, device_probe="on", native_shards=1),
              **DEVICE_TIER, **kw}
    if side == "jax":
        with _jax_x64():
            op = JaxOp(_assigner(side, window), jagg(), **common)
            op.open(jfn.RuntimeContext())
        return op
    op = WindowAggOperator(_assigner(side, window), pagg(), device="cpu",
                           **common)
    op.open(pfn.RuntimeContext())
    return op


def _stream(seed=3, n_batches=10, bsz=700):
    """Seeded batches: the key range widens over time (key growth), event
    time advances 60 ms a batch, batch 6 is out of order (part of it within
    the lateness: re-fires; part beyond: dropped), and watermarks come after
    every third batch (the live pane span outgrows the ring)."""
    rng = np.random.default_rng(seed)
    out = []
    t = 0
    for i in range(n_batches):
        keys = rng.integers(0, 150 + 60 * i, bsz).astype(np.int64)
        vals = (rng.standard_normal(bsz) * 10).astype(np.float32)
        if i == 6:
            ts = np.sort(rng.integers(t - 400, t, bsz)).astype(np.int64)
        else:
            ts = t + np.sort(rng.integers(0, 60, bsz)).astype(np.int64)
            t += 60
        wm = int(t) - 1 if i % 3 == 2 else None
        out.append((keys, vals, ts, wm))
    return out


STREAM = _stream()


def _drive(op, RB, WM, stream=STREAM, snap_at=SNAP_AT):
    """Fires (with the call each surfaced in), the mid-run snapshot (taken
    after the pre-barrier drain) and the counters."""
    fired, snap = [], None
    for i, (keys, vals, ts, wm) in enumerate(stream):
        out = op.process_batch(RB({"k": keys, "v": vals}, timestamps=ts))
        if wm is not None:
            out += op.process_watermark(WM(wm))
        if i == snap_at:
            out += op.prepare_snapshot_pre_barrier()
            snap = op.snapshot_state()
        fired += [(i, b) for b in out]
    fired += [(len(stream), b) for b in op.end_input()]
    return fired, snap, {"late_dropped": op.late_dropped,
                         "watermark": op.watermark,
                         "last_fired_window": op.last_fired_window}


def _run(side, agg="sum", window="tumbling", **kw):
    op = _make(side, agg, window, **kw)
    if side == "jax":
        with _jax_x64():
            return _drive(op, JaxBatch, JaxWatermark) + (op,)
    return _drive(op, RecordBatch, Watermark) + (op,)


@functools.lru_cache(maxsize=None)
def _jax_run(agg, window):
    return _run("jax", agg, window)


def _result_cols(b):
    return sorted(c for c in b.columns if c not in ("k", "window_start",
                                                    "window_end"))


def _digest(b):
    """The bit-for-bit view of a fired batch."""
    return (int(np.asarray(b.column("window_start"))[0]),
            int(np.asarray(b.column("window_end"))[0]),
            np.asarray(b.column("k")).tobytes(),
            tuple((c, np.asarray(b.column(c)).dtype.str,
                   np.asarray(b.column(c)).tobytes())
                  for c in _result_cols(b)))


def _digests(fired):
    return [_digest(b) for _, b in fired if len(b)]


def _calls(fired):
    """The driver call each non-empty fire surfaced in."""
    return [i for i, b in fired if len(b)]


def _assert_snaps_bit_equal(got, want):
    for k in ("pane_base", "max_pane", "last_fired_window", "watermark",
              "late_dropped", "P", "key_index_kind"):
        assert got[k] == want[k], k
    assert [dict(s) for s in got["leaf_schema"]] == \
        [dict(s) for s in want["leaf_schema"]]
    for k in ("panes", "counts"):
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(got[k], want[k]), k
    assert np.array_equal(got["key_index"]["reverse"],
                          want["key_index"]["reverse"])
    assert len(got["leaves"]) == len(want["leaves"])
    for g, w in zip(got["leaves"], want["leaves"]):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


# ---------------------------------------------------------------------------
# the device tier against JAX's, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lane", list(LANES))
@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("agg", list(AGGS))
def test_fires_and_snapshots_bit_equal_jax(agg, window, lane):
    jfired, jsnap, jcnt, _ = _jax_run(agg, window)
    pfired, psnap, pcnt, op = _run("port", agg, window, **LANES[lane])
    assert _digests(pfired) == _digests(jfired)
    assert _calls(pfired) == _calls(jfired)
    _assert_snaps_bit_equal(psnap, snapshot_from_jax(jsnap))
    assert pcnt == jcnt


def test_the_stream_exercises_growth_expiry_and_late_paths():
    """The shared stream really grows keys and panes, drops late records,
    re-fires and expires (checked once, on the port's plain lane)."""
    fired, snap, cnt, op = _run("port", "sum", "tumbling")
    assert op._K > 64 and snap["P"] > 2
    assert 0 < cnt["late_dropped"] < 700
    starts = [int(np.asarray(b.column("window_start"))[0])
              for _, b in fired if len(b)]
    assert len(starts) > len(set(starts))          # late re-fires
    assert op.pane_base > int(snap["pane_base"])   # panes expired since
    assert all(p >= op.pane_base for p in op._mirror)   # ... and left it


def test_device_tier_lanes_keep_the_probe_off_and_no_value_mirror():
    _, _, _, op = _run("port", "sum", "tumbling", superbatch=4,
                       native_emit=True)
    assert op.device_probe_stats()["enabled"] == 0
    assert isinstance(op.key_index, NativeKeyIndex)
    assert not op.native_mirror_active and not op._vmirror
    assert op.fused_stats()["host_super_passes"] > 0
    assert op.phase_bytes["d2h"] > 0 and op.phase_bytes["h2d"] > 0
    assert "emit_mirror" in op.phase_ns and "fire" in op.phase_ns
    assert op.verify_mirror()                      # no mirror to disagree
    _, _, _, plain = _run("port", "sum", "tumbling")
    assert isinstance(plain.key_index, KeyIndex)


def test_int64_sum_values_match_jax():
    """An int64 sum: JAX without x64 keeps the leaf (and so the fires and
    snapshot leaves) in int32, the port in int64; the values agree."""
    JAX_INT = np.int64 if jax.config.jax_enable_x64 else np.int32
    stream = [(k, (v * 100).astype(np.int64), ts, wm)
              for k, v, ts, wm in STREAM]

    def make(side):
        agg = (jfn.SumAggregator(jnp.int64) if side == "jax"
               else pfn.SumAggregator(torch.int64))
        mod = jwin if side == "jax" else pwin
        kw = dict(key_column="k", value_column="v",
                  allowed_lateness_ms=LATENESS, **DEVICE_TIER)
        if side == "jax":
            op = JaxOp(mod.TumblingEventTimeWindows.of(100), agg, **kw)
            op.open(jfn.RuntimeContext())
        else:
            op = WindowAggOperator(mod.TumblingEventTimeWindows.of(100), agg,
                                   device="cpu", **kw)
            op.open(pfn.RuntimeContext())
        return op

    with _jax_x64():
        jfired, jsnap, _ = _drive(make("jax"), JaxBatch, JaxWatermark,
                                  stream)
    pfired, psnap, _ = _drive(make("port"), RecordBatch, Watermark, stream)
    assert len(pfired) == len(jfired) > 0
    for (_, p), (_, j) in zip(pfired, jfired):
        pr, jr = np.asarray(p.column("result")), np.asarray(j.column("result"))
        assert pr.dtype == np.int64 and jr.dtype == JAX_INT
        assert np.array_equal(np.asarray(p.column("k")),
                              np.asarray(j.column("k")))
        assert np.array_equal(pr, jr.astype(np.int64))
    assert psnap["leaves"][0].dtype == np.int64
    assert jsnap["leaves"][0].dtype == JAX_INT
    assert np.array_equal(psnap["leaves"][0],
                          jsnap["leaves"][0].astype(np.int64))


# ---------------------------------------------------------------------------
# async_fire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lane", ["sb1", "sb4-native"])
def test_async_fire_same_results_one_call_later(lane):
    """``async_fire`` surfaces exactly the fires of the synchronous run, in
    the same order, each at most one driver call later (on the CPU a
    download is ready at once, so it surfaces at the next call), and the
    JAX operator's async device tier surfaces the same fires, none early
    (its CPU dispatch is asynchronous, so a download may report ready some
    calls later there)."""
    sync, _, _, _ = _run("port", **LANES[lane])
    fired, _, _, op = _run("port", async_fire=True, **LANES[lane])
    assert _digests(fired) == _digests(sync)
    lag = [a - s for a, s in zip(_calls(fired), _calls(sync))]
    assert set(lag) <= {0, 1} and 1 in lag
    assert not op._pending_fires
    with _jax_x64():
        jop = _make("jax", async_fire=True)
        jfired, _, _ = _drive(jop, JaxBatch, JaxWatermark)
    assert _digests(fired) == _digests(jfired)
    assert all(a >= s for a, s in zip(_calls(jfired), _calls(sync)))


def test_async_fire_prepare_snapshot_pre_barrier():
    """A fire started by a watermark is pending: ``snapshot_state`` refuses
    until ``prepare_snapshot_pre_barrier`` drains it, then succeeds."""
    op = _make("port", async_fire=True)
    op.process_batch(RecordBatch({"k": np.arange(8),
                                  "v": np.ones(8, np.float32)},
                                 timestamps=np.full(8, 50)))
    out = op.process_watermark(Watermark(99))    # starts an async fire
    assert out == [] and len(op._pending_fires) == 1
    with pytest.raises(ValueError, match="prepare_snapshot_pre_barrier"):
        op.snapshot_state()
    drained = op.prepare_snapshot_pre_barrier()
    assert sum(len(b) for b in drained) == 8
    snap = op.snapshot_state()                   # no longer refuses
    assert snap["watermark"] == 99


def test_async_fire_drain_is_forced_past_three_pending():
    op = _make("port", async_fire=True)
    op.process_batch(RecordBatch({"k": np.arange(8),
                                  "v": np.ones(8, np.float32)},
                                 timestamps=np.arange(8) * 100))
    # a handle that never reports ready: only a forced drain takes it
    op.process_watermark(Watermark(399))
    assert len(op._pending_fires) == 4
    op._pending_fires = [(w, k, (h, _NeverReady(), d), s)
                         for w, k, (h, _e, d), s in op._pending_fires]
    assert op.drain_pending_fires() != []        # 4 > 3: forced
    assert not op._pending_fires
    op.process_watermark(Watermark(499))
    op._pending_fires = [(w, k, (h, _NeverReady(), d), s)
                         for w, k, (h, _e, d), s in op._pending_fires]
    assert op.drain_pending_fires() == []        # 1 pending, not ready
    assert len(op.drain_pending_fires(force=True)) == 1


class _NeverReady:
    def query(self):
        return False

    def synchronize(self):
        pass


# ---------------------------------------------------------------------------
# restores across tiers and packages
# ---------------------------------------------------------------------------

def _finish(op, RB, WM, stream=STREAM[SNAP_AT + 1:]):
    out = []
    for keys, vals, ts, wm in stream:
        out += op.process_batch(RB({"k": keys, "v": vals}, timestamps=ts))
        if wm is not None:
            out += op.process_watermark(WM(wm))
    return out + op.end_input()


def _host_port(**kw):
    return _make("port", emit_tier="host", snapshot_source="mirror",
                 device_probe="off", **kw)


@pytest.mark.parametrize("into", ["port-host", "port-device", "jax-host",
                                  "jax-device"])
def test_device_snapshot_restores_across_tiers_and_packages(into):
    """The port's device-tier snapshot restores into either tier of either
    package; every continuation fires what the uninterrupted device-tier
    run fired after the snapshot (values to 1e-6 on the host tier, whose
    mirror re-accumulates in f64; bit for bit on the device tiers)."""
    fired, snap, _, _ = _run("port", "avg", "sliding")
    after = [b for i, b in fired if i > SNAP_AT and len(b)]
    side, tier = into.split("-")
    if side == "port":
        op = (_host_port(agg="avg", window="sliding") if tier == "host"
              else _make("port", "avg", "sliding"))
        op.restore_state(snap)
        got = _finish(op, RecordBatch, Watermark)
    else:
        kw = (dict(emit_tier="host", snapshot_source="mirror",
                   device_probe="off", native_emit=False)
              if tier == "host" else {})
        op = _make("jax", "avg", "sliding", **kw)
        with _jax_x64():
            op.restore_state(snapshot_to_jax(snap))
            got = _finish(op, JaxBatch, JaxWatermark)
    got = [b for b in got if len(b)]
    if tier == "device":
        assert [_digest(b) for b in got] == [_digest(b) for b in after]
        return
    assert len(got) == len(after)
    for g, w in zip(got, after):
        assert np.array_equal(np.asarray(g.column("k")),
                              np.asarray(w.column("k")))
        np.testing.assert_allclose(np.asarray(g.column("result")),
                                   np.asarray(w.column("result")),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("source", ["port-host", "jax-host", "jax-device"])
def test_snapshots_restore_into_the_device_tier(source):
    """Host-tier snapshots (mirror-sourced, either package) and JAX's
    device-tier snapshot restore into the port's device tier, whose
    continuation fires what JAX's device tier fires from the same
    snapshot."""
    side, tier = source.split("-")
    kw = (dict(emit_tier="host", snapshot_source="mirror",
               device_probe="off", native_emit=False)
          if tier == "host" else {})
    if side == "port":
        _, snap, _, _ = _run("port", "sum", "tumbling", **kw)
    else:
        _, snap, _, _ = _run("jax", "sum", "tumbling", **kw)
        snap = snapshot_from_jax(snap)
    op = _make("port")
    op.restore_state(snap)
    got = [b for b in _finish(op, RecordBatch, Watermark) if len(b)]
    ref = _make("jax")
    with _jax_x64():
        ref.restore_state(snapshot_to_jax(snap))
        want = [b for b in _finish(ref, JaxBatch, JaxWatermark) if len(b)]
    assert [_digest(b) for b in got] == [_digest(b) for b in want]
    assert len(got) > 0


def test_host_tier_device_sourced_snapshot_equals_the_mirror_one():
    """The host tier may source snapshots from the replica (scatter sync):
    the same format, and the same cells as the mirror-sourced snapshot in
    the replica's precision."""
    _, dsnap, _, _ = _run("port", emit_tier="host", snapshot_source="device",
                          device_probe="on")
    _, msnap, _, _ = _run("port", emit_tier="host", snapshot_source="mirror",
                          device_probe="on")
    assert np.array_equal(dsnap["counts"], msnap["counts"])
    assert dsnap["leaves"][0].dtype == msnap["leaves"][0].dtype
    np.testing.assert_allclose(dsnap["leaves"][0], msnap["leaves"][0],
                               rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# constructor rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw, match", [
    (dict(emit_tier="device", snapshot_source="mirror"), "mirror"),
    (dict(emit_tier="device", device_sync="deferred"), "deferred"),
    (dict(emit_tier="host", device_sync="deferred",
          snapshot_source="device"), "deferred"),
    (dict(emit_tier="tpu", snapshot_source="device"), "emit_tier"),
    (dict(emit_tier="device", snapshot_source="disk"), "snapshot_source"),
])
def test_constructor_refuses_what_jax_refuses(kw, match):
    """As the JAX operator: a mirror-sourced snapshot needs the host tier,
    deferred sync needs the host tier and a mirror-sourced snapshot."""
    base = dict(key_column="k", value_column="v", device="cpu",
                snapshot_source="device")
    with pytest.raises(ValueError, match=match):
        WindowAggOperator(pwin.TumblingEventTimeWindows.of(100),
                          pfn.SumAggregator(), **{**base, **kw})
    jkw = {k: v for k, v in {**base, **kw}.items() if k != "device"}
    if "tpu" not in jkw.values() and "disk" not in jkw.values():
        with pytest.raises(ValueError):
            JaxOp(jwin.TumblingEventTimeWindows.of(100),
                  jfn.SumAggregator(jnp.float32), **jkw)


def test_device_tier_accepts_what_the_host_tier_refuses():
    """``native_shards=0`` (the host tier's measured auto) is unused on the
    device tier, and ``device_probe="on"`` is accepted and inactive."""
    op = WindowAggOperator(pwin.TumblingEventTimeWindows.of(100),
                           pfn.SumAggregator(), key_column="k",
                           value_column="v", device="cpu",
                           emit_tier="device", snapshot_source="device",
                           native_emit=True, native_shards=0,
                           async_fire=True, device_probe="on")
    op.process_batch(RecordBatch({"k": np.arange(5),
                                  "v": np.ones(5, np.float32)},
                                 timestamps=np.full(5, 10)))
    assert op.device_probe_stats()["enabled"] == 0
    assert not op.native_mirror_active


# ---------------------------------------------------------------------------
# the ops: the ordered fold's plain version and the pane combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ids_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("kinds", [("add",), ("add", "add"), ("min",),
                                   ("max", "add")])
def test_ordered_fold_counts_matches_jax_on_the_cpu(kinds, ids_dtype):
    """Same seeded ids (repeated, and the dropped id N) and values through
    JAX's ``scatter_fold_counts`` and the port's ``ordered_fold_counts``:
    bit for bit, in place, no launch counted on the CPU."""
    rng = np.random.default_rng(5)
    N, B = 96, 700
    ids = rng.integers(0, N + 1, B).astype(ids_dtype)
    ids[:30] = N
    vals = [(rng.standard_normal(B) * 10).astype(np.float32) for _ in kinds]
    init = {"add": 0.0, "min": np.inf, "max": -np.inf}
    state = [np.where(rng.random(N) < 0.5, init[k],
                      rng.standard_normal(N) * 3).astype(np.float32)
             for k in kinds]
    counts = rng.integers(0, 5, N).astype(np.int32)
    wl, wc = jsc.scatter_fold_counts(
        tuple(jnp.asarray(s) for s in state), jnp.asarray(counts),
        jnp.asarray(ids.astype(np.int32)),
        tuple(jnp.asarray(v) for v in vals), kinds)
    t_state = tuple(torch.from_numpy(s.copy()) for s in state)
    t_counts = torch.from_numpy(counts.copy())
    before = tsc.ordered_fold_counts.launches
    gl, gc = tsc.ordered_fold_counts(t_state, t_counts, torch.from_numpy(ids),
                                     tuple(torch.from_numpy(v) for v in vals),
                                     kinds)
    assert tsc.ordered_fold_counts.launches == before
    assert gc is t_counts and all(g is t for g, t in zip(gl, t_state))
    assert np.array_equal(gc.numpy(), np.asarray(wc))
    for g, w in zip(gl, wl):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


@pytest.mark.parametrize("m", [1, 2, 3, 5, 7])
def test_combine_along_axis_matches_jax(m):
    """The pane combine in JAX's pairwise order, odd tails included: the f32
    sums are bit-equal (a sequential sum would round differently)."""
    rng = np.random.default_rng(m)
    a = (rng.standard_normal((200, m)) * 1e3).astype(np.float32)
    b = rng.integers(-9, 9, (200, m)).astype(np.int32)
    agg_j, agg_p = AGGS["avg"][0](), AGGS["avg"][1]()
    want = jsc.combine_along_axis((jnp.asarray(b), jnp.asarray(a)),
                                  agg_j.combine_leaves, axis=1)
    got = tsc.combine_along_axis((torch.from_numpy(b), torch.from_numpy(a)),
                                 agg_p.combine_leaves, axis=1)
    for g, w in zip(got, want):
        assert g.shape == (200,)
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    keep = tsc.combine_along_axis((torch.from_numpy(a),), lambda x, y: tuple(
        p + q for p, q in zip(x, y)), axis=1, keepdims=True)
    assert keep[0].shape == (200, 1)


@pytest.mark.parametrize("n_cells, bits, tiles", [
    (1 << 24, 14, 1024),            # the main path's 2^20 keys x 16 panes
    ((1 << 24) + 1, 15, 513),       # one key row more raises tile_bits
    (1 << 25, 15, 1024),
    (1 << 30, 20, 1024),
    (100, 8, 1),
])
def test_fold_plan_raises_tile_bits_as_cells_grow(n_cells, bits, tiles):
    assert tsc.fold_plan(1 << 18, n_cells)[:2] == (bits, tiles)

"""Port parity for slice 2: deferred sync and the fused super-batch lane of
``flink_tpu_torch``'s ``WindowAggOperator``, against ``flink_tpu``'s and
against the JAX package's own contract (``tests/test_fused_step.py``,
``tests/test_device_sync.py::TestDeferredSync``).

The stream is ``tests/test_fused_step.py``'s ``_seeded_run``: window 100,
1500 keys, 4000-row batches, 12 batches, key growth from
``initial_key_capacity=1<<10``, a snapshot after batch 6.  Both packages run
the host emit tier with the numpy mirror, no pipelining, and pinned values
only: ``device_probe`` "on"/"off", ``device_sync`` "deferred"/"scatter"
(never "auto", whose calibration is not the spec).  The JAX side runs under
the ``_jax_x64`` shim (its probe lane imports ``jax.experimental.enable_x64``,
which jax 0.9 moved); its probe is ``lax_probe``, and its scan body takes
probe + ``scatter_fold_counts`` because the Pallas gate is off on the CPU.

Port against JAX: fires are held to rtol=atol=1e-6 per window sorted by key,
and snapshots as key -> cell maps; on the CPU they are in fact bit-equal
(``test_fires_bit_equal_jax``), and slot ids agree, since both key indexes
number new keys in order of first occurrence.
"""

import contextlib

import numpy as np
import pytest

import jax
import jax.experimental
import jax.numpy as jnp

from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.core.batch import Watermark as JaxWatermark
from flink_tpu.core.functions import RuntimeContext as JaxContext
from flink_tpu.core.functions import SumAggregator as JaxSum
from flink_tpu.operators.window_agg import WindowAggOperator as JaxOp
from flink_tpu.windowing.assigners import TumblingEventTimeWindows as JaxTumbling
from flink_tpu_torch.core.batch import RecordBatch, Watermark
from flink_tpu_torch.core.functions import RuntimeContext, SumAggregator
from flink_tpu_torch.interop import snapshot_from_jax, snapshot_to_jax
from flink_tpu_torch.operators import window_agg as port_window_agg
from flink_tpu_torch.operators.window_agg import WindowAggOperator
from flink_tpu_torch.state import device_keyindex as port_dki
from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

RTOL = ATOL = 1e-6
SNAP_AT = 6

CONFIGS = {
    "deferred-sb4-on": dict(device_sync="deferred", superbatch=4,
                            device_probe="on"),
    "scatter-sb4-on": dict(device_sync="scatter", superbatch=4,
                           device_probe="on"),
    "deferred-sb1-on": dict(device_sync="deferred", superbatch=1,
                            device_probe="on"),
    "deferred-sb1-off": dict(device_sync="deferred", superbatch=1,
                             device_probe="off"),
}
FUSED_KEYS = ("staged_batches", "flushes", "scan_dispatches", "scan_steps",
              "host_super_passes", "staged_pending")


@contextlib.contextmanager
def _jax_x64():
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64",
                       lambda new_val=True: jax.enable_x64(new_val),
                       raising=False)
        yield


def _batches(n_batches=12, nk=1500, b=4000, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        keys = rng.integers(0, nk, b).astype(np.int64)
        vals = rng.random(b).astype(np.float32)
        ts = i * 50 + np.sort(rng.integers(0, 50, b)).astype(np.int64)
        out.append((keys, vals, ts))
    return out


BATCHES = _batches()


def _jax_op(**kw):
    op = JaxOp(JaxTumbling.of(100), JaxSum(jnp.float32), key_column="k",
               value_column="v", emit_tier="host", snapshot_source="mirror",
               native_emit=False, pipeline_depth=0,
               initial_key_capacity=1 << 10, **kw)
    op.open(JaxContext())
    return op


def _port_op(**kw):
    # the probe pinned on where a test leaves it out, never measured
    kw.setdefault("device_probe", "on")
    op = WindowAggOperator(TumblingEventTimeWindows.of(100), SumAggregator(),
                           key_column="k", value_column="v",
                           emit_tier="host", snapshot_source="mirror",
                           native_emit=False, pipeline_depth=0,
                           initial_key_capacity=1 << 10, device="cpu", **kw)
    op.open(RuntimeContext())
    return op


def _drive(op, batches, RB=RecordBatch, WM=Watermark, snap_at=None):
    """Feed batches, a watermark after each; returns (fires before the
    snapshot, fires after it, snapshot)."""
    before, after, snap = [], [], None
    for i, (keys, vals, ts) in enumerate(batches):
        out = op.process_batch(RB({"k": keys, "v": vals}, timestamps=ts))
        out += op.process_watermark(WM(int(ts.max()) - 1))
        (after if snap is not None else before).extend(out)
        if i == snap_at:
            op.prepare_snapshot_pre_barrier()
            snap = op.snapshot_state()
    (after if snap is not None else before).extend(op.end_input())
    return before, after, snap


def _digests(out):
    return [(int(np.asarray(b.column("window_start"))[0]), len(b),
             np.asarray(b.column("k")).tobytes(),
             np.asarray(b.column("result")).tobytes()) for b in out]


def _snap_bytes(snap):
    return (snap["counts"].tobytes(),
            tuple(np.asarray(l).tobytes() for l in snap["leaves"]),
            np.asarray(snap["key_index"]["reverse"]).tobytes())


def _counters(op):
    s = op.device_probe_stats()
    f = op.fused_stats()
    return {"late_dropped": op.late_dropped,
            "num_keys": op.key_index.num_keys if op.key_index else 0,
            "watermark": op.watermark,
            "last_fired_window": op.last_fired_window,
            "probe_hits": s["probe_hits"], "probe_misses": s["probe_misses"],
            **{k: f[k] for k in FUSED_KEYS}}


def _assert_fires_equal(got, want):
    """Per window, sorted by key: same keys, results to rtol/atol 1e-6."""
    assert [int(np.asarray(b.column("window_start"))[0]) for b in got] == \
        [int(np.asarray(b.column("window_start"))[0]) for b in want]
    for g, w in zip(got, want):
        gk, wk = np.asarray(g.column("k")), np.asarray(w.column("k"))
        go, wo = np.argsort(gk, kind="stable"), np.argsort(wk, kind="stable")
        assert np.array_equal(gk[go], wk[wo])
        gr, wr = np.asarray(g.column("result")), np.asarray(w.column("result"))
        assert gr.dtype == wr.dtype
        np.testing.assert_allclose(gr[go], wr[wo], rtol=RTOL, atol=ATOL)


def _cells(snap):
    keys = np.asarray(snap["key_index"]["reverse"])
    order = np.argsort(keys)
    return (keys[order], np.asarray(snap["counts"])[order],
            [np.asarray(l)[order] for l in snap["leaves"]])


def _assert_snap_equivalent(got, want):
    """Scalars equal; key -> (counts, leaves) maps equal (leaves to 1e-6)."""
    for k in ("pane_base", "max_pane", "last_fired_window", "watermark",
              "late_dropped", "P", "key_index_kind", "leaf_schema"):
        assert got[k] == want[k], k
    assert np.array_equal(got["panes"], want["panes"])
    (gk, gc, gl), (wk, wc, wl) = _cells(got), _cells(want)
    assert np.array_equal(gk, wk)
    assert gc.dtype == wc.dtype and np.array_equal(gc, wc)
    for g, w in zip(gl, wl):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def jax_runs():
    runs = {}
    with _jax_x64():
        for name, kw in CONFIGS.items():
            op = _jax_op(**kw)
            before, after, snap = _drive(op, BATCHES, JaxBatch, JaxWatermark,
                                         SNAP_AT)
            runs[name] = (before, after, snap, _counters(op))
    return runs


@pytest.fixture(scope="module")
def port_runs():
    runs = {}
    for name, kw in CONFIGS.items():
        op = _port_op(**kw)
        before, after, snap = _drive(op, BATCHES, snap_at=SNAP_AT)
        assert op.verify_mirror()
        runs[name] = (before, after, snap, _counters(op))
    return runs


# ---------------------------------------------------------------------------
# the port against JAX, one configuration on both sides
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_fires_equal_jax(cfg, jax_runs, port_runs):
    _assert_fires_equal(port_runs[cfg][0] + port_runs[cfg][1],
                        jax_runs[cfg][0] + jax_runs[cfg][1])


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_fires_bit_equal_jax(cfg, jax_runs, port_runs):
    """Stronger than the 1e-6 comparison, and true on the CPU today: the
    same slot ids, so the same row order, and the same bits (both fold in
    row order into f64 mirrors and f64 delta planes)."""
    assert _digests(port_runs[cfg][0] + port_runs[cfg][1]) == \
        _digests(jax_runs[cfg][0] + jax_runs[cfg][1])


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_counters_equal_jax(cfg, jax_runs, port_runs):
    """late_dropped, num_keys, watermark, last_fired_window, probe hits and
    misses, and the fused lane's counters."""
    assert port_runs[cfg][3] == jax_runs[cfg][3]


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_snapshots_equivalent(cfg, jax_runs, port_runs):
    want = snapshot_from_jax(jax_runs[cfg][2])
    _assert_snap_equivalent(port_runs[cfg][2], want)
    assert np.array_equal(port_runs[cfg][2]["key_index"]["reverse"],
                          want["key_index"]["reverse"])


def test_fused_runs_scanned_on_both_sides(jax_runs, port_runs):
    for cfg in ("deferred-sb4-on", "scatter-sb4-on"):
        c = port_runs[cfg][3]
        assert c["scan_dispatches"] > 0
        assert c["scan_steps"] > c["scan_dispatches"]
        assert c["staged_pending"] == 0


def test_state_carried_from_jax_into_the_port(jax_runs):
    """A JAX snapshot taken mid-stream under deferred + superbatch restores
    into the port, whose remaining fires equal JAX's."""
    _before, after, snap, _c = jax_runs["deferred-sb4-on"]
    op = _port_op(**CONFIGS["deferred-sb4-on"])
    op.restore_state(snapshot_from_jax(snap))
    b, a, _ = _drive(op, BATCHES[SNAP_AT + 1:])
    _assert_fires_equal(b + a, after)
    assert op.verify_mirror()


def test_state_carried_from_the_port_into_jax(port_runs):
    _before, after, snap, _c = port_runs["deferred-sb4-on"]
    with _jax_x64():
        op = _jax_op(**CONFIGS["deferred-sb4-on"])
        op.restore_state(snapshot_to_jax(snap))
        b, a, _ = _drive(op, BATCHES[SNAP_AT + 1:], JaxBatch, JaxWatermark)
    _assert_fires_equal(b + a, after)


# ---------------------------------------------------------------------------
# inside the port: the JAX package's own contract for the fused lane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sync", ["deferred", "scatter"])
@pytest.mark.parametrize("device_probe", ["on", "off"])
def test_fused_on_off_bit_identical(sync, device_probe):
    """Staging is pure scheduling: fire digests, snapshot bytes and
    counters (probe hit/miss counts aside) are bit-identical fused on and
    off, under both cadences, probe on and off."""
    kw = dict(device_sync=sync, device_probe=device_probe)
    runs = []
    for superbatch in (1, 4):
        op = _port_op(superbatch=superbatch, **kw)
        before, after, snap = _drive(op, BATCHES, snap_at=SNAP_AT)
        assert op.verify_mirror()
        runs.append((_digests(before + after), _snap_bytes(snap),
                     _counters(op)))
    (ref_d, ref_s, ref_c), (got_d, got_s, got_c) = runs
    assert got_d == ref_d, "fire digests diverged"
    assert got_s == ref_s, "snapshot diverged"
    for k in ("late_dropped", "num_keys", "watermark", "last_fired_window"):
        assert got_c[k] == ref_c[k], k
    if device_probe == "on":
        assert got_c["scan_dispatches"] > 0, "the one-step lane never ran"
        assert got_c["scan_steps"] > got_c["scan_dispatches"], \
            "one-step passes did not cover several staged batches"
    else:
        assert got_c["host_super_passes"] > 0


@pytest.mark.parametrize("sync,want_calls", [("deferred", True),
                                             ("scatter", False)])
def test_probe_fold_carries_the_deferred_fused_lane(monkeypatch, sync,
                                                    want_calls):
    """Every one-step pass under deferred sync is one probe_fold call (the
    kernel on the card); scatter sync folds the replica too and takes the
    probed update step instead, as JAX's gate only serves the delta-only
    carry."""
    calls = []
    real = port_window_agg.probe_fold

    def counting(*args):
        calls.append(args[3])                       # b: the block's rows
        return real(*args)

    monkeypatch.setattr(port_window_agg, "probe_fold", counting)
    op = _port_op(device_sync=sync, superbatch=4, device_probe="on")
    _drive(op, BATCHES)
    scans = op.fused_stats()["scan_dispatches"]
    assert scans > 0
    assert len(calls) == (scans if want_calls else 0)
    assert all(b > 4000 for b in calls), "a call covered a single batch"


@pytest.mark.parametrize("sync,superbatch", [("scatter", 1),
                                             ("deferred", 4),
                                             ("scatter", 4)])
def test_probe_lane_hashes_no_record_on_the_host(monkeypatch, sync,
                                                 superbatch):
    """The card hashes the keys: over a whole probe-lane run the host hashes
    (``probe_starts``) and splits (``split_keys``) only the keys it inserts
    into the device table, never a batch's records."""
    hashed, split, placed = [], [], []
    for name, log in (("probe_starts", hashed), ("split_keys", split)):
        real = getattr(port_dki, name)

        def counting(keys, *rest, _real=real, _log=log):
            _log.append(int(np.asarray(keys).size))
            return _real(keys, *rest)

        monkeypatch.setattr(port_dki, name, counting)
    real_place = port_dki.DeviceKeyIndex._place

    def placing(self, keys):
        placed.append(int(keys.size))
        return real_place(self, keys)

    monkeypatch.setattr(port_dki.DeviceKeyIndex, "_place", placing)
    op = _port_op(device_sync=sync, superbatch=superbatch, device_probe="on")
    _drive(op, BATCHES)
    records = sum(len(b[0]) for b in BATCHES)
    stats = op.device_probe_stats()
    assert stats["probe_hits"] + stats["probe_misses"] == records
    assert stats["probe_hits"] > records // 2
    assert sum(placed) >= op.key_index.num_keys > 0
    assert sum(hashed) == sum(placed), "a record was hashed on the host"
    assert sum(split) == sum(placed), "a record was split on the host"
    assert sum(hashed) < records // 2


def test_watermark_fast_path_keeps_batches_staged():
    """A watermark that passes no window end leaves the stage parked; the
    one that crosses a fire boundary flushes and fires; a snapshot flushes
    too (``tests/test_fused_step.py:174``)."""
    op = _port_op(device_sync="deferred", superbatch=8, device_probe="on")
    rng = np.random.default_rng(5)
    k = rng.integers(0, 64, 512).astype(np.int64)
    v = np.ones(512, np.float32)
    out = op.process_batch(RecordBatch(
        {"k": k, "v": v}, timestamps=np.full(512, 50, np.int64)))
    out += op.process_watermark(Watermark(99))
    assert _digests(out), "first window did not fire"
    staged_seen = 0
    for i in range(3):   # all inside window [100, 200): no boundary
        ts = 100 + i * 20 + np.sort(rng.integers(0, 20, 512)).astype(np.int64)
        op.process_batch(RecordBatch({"k": k, "v": v}, timestamps=ts))
        assert op.process_watermark(Watermark(int(ts.max()) - 1)) == []
        staged_seen = max(staged_seen, op.fused_stats()["staged_pending"])
    assert staged_seen >= 2, "watermarks flushed the stage prematurely"
    fired = op.process_watermark(Watermark(199))   # boundary: flush + fire
    assert _digests(fired), "boundary watermark did not fire"
    assert int(np.asarray(fired[0].column("result")).sum()) == 3 * 512
    assert op.fused_stats()["staged_pending"] == 0
    op.process_batch(RecordBatch(
        {"k": k, "v": v}, timestamps=np.full(512, 250, np.int64)))
    assert op.fused_stats()["staged_pending"] == 1
    op.prepare_snapshot_pre_barrier()
    snap = op.snapshot_state()
    assert op.fused_stats()["staged_pending"] == 0
    assert snap["counts"].sum() >= 512, "snapshot missed staged rows"
    op.process_batch(RecordBatch(
        {"k": k, "v": v}, timestamps=np.full(512, 260, np.int64)))
    assert op.end_input() and op.fused_stats()["staged_pending"] == 0


def test_single_batch_flush_is_not_a_super_pass():
    """Every watermark fires, so the stage never holds more than one batch:
    each drain is the plain per-batch path (``:403``)."""
    op = _port_op(device_sync="deferred", superbatch=4, device_probe="on")
    rng = np.random.default_rng(3)
    for i in range(5):
        keys = rng.integers(0, 512, 1024).astype(np.int64)
        vals = rng.random(1024).astype(np.float32)
        op.process_batch(RecordBatch({"k": keys, "v": vals},
                                     timestamps=np.full(1024, i * 100 + 50,
                                                        np.int64)))
        op.process_watermark(Watermark(i * 100 + 99))
    fu = op.fused_stats()
    assert fu["flushes"] >= 5
    assert fu["host_super_passes"] == 0 and fu["scan_dispatches"] == 0


def test_late_refire_flushes_the_stage():
    """An out-of-order batch that touches an already-fired window re-fires
    it from state that holds the staged rows: fused and unfused fire alike,
    late drops included."""
    batches = list(BATCHES[:9])
    keys, vals, _ts = batches[8]
    rng = np.random.default_rng(8)
    batches[8] = (keys, vals,
                  250 + np.sort(rng.integers(0, 100, keys.size)).astype(
                      np.int64))
    runs = []
    for superbatch in (1, 4):
        op = _port_op(device_sync="deferred", superbatch=superbatch)
        before, after, _ = _drive(op, batches)
        runs.append((_digests(before + after), op.late_dropped))
    assert runs[0] == runs[1]
    assert 0 < runs[0][1] < 4000


def _replay(snap, **kw):
    op = _port_op(**kw)
    op.restore_state(snap)
    before, after, _ = _drive(op, BATCHES[SNAP_AT + 1:])
    return op, before + after


@pytest.fixture(scope="module")
def cross_snapshots():
    """Mid-stream snapshots of one stream under each cadence, fused and not,
    the uninterrupted run's tail, and the tail replayed from one of them."""
    snaps = {}
    for sync in ("deferred", "scatter"):
        for superbatch in (1, 4):
            op = _port_op(device_sync=sync, superbatch=superbatch)
            _b, after, snap = _drive(op, BATCHES, snap_at=SNAP_AT)
            snaps[(sync, superbatch)] = snap
    replayed = _replay(snaps[("deferred", 1)], device_sync="deferred")[1]
    return snaps, after, _digests(replayed)


@pytest.mark.parametrize("dst_sync", ["deferred", "scatter"])
@pytest.mark.parametrize("dst_superbatch", [1, 4])
def test_restore_across_lanes_and_cadences(cross_snapshots, dst_sync,
                                           dst_superbatch):
    """Snapshots written by either lane under either cadence are
    byte-identical; each restores into every lane and cadence with the same
    replayed tail, bit for bit (``tests/test_fused_step.py:211``,
    ``TestDeferredSync.test_snapshot_restore_across_cadences``).  The tail
    equals the uninterrupted run's to 1e-6: a restore re-seeds the mirror
    in device precision (f32), as the JAX operator's does."""
    snaps, uninterrupted, want = cross_snapshots
    ref = _snap_bytes(snaps[("deferred", 1)])
    for src, snap in snaps.items():
        assert _snap_bytes(snap) == ref, f"{src} snapshot differs"
        op, tail = _replay(snap, device_sync=dst_sync,
                           superbatch=dst_superbatch)
        assert op._device_stale == (dst_sync == "deferred")
        assert _digests(tail) == want, f"restore {src} diverged"
        _assert_fires_equal(tail, uninterrupted)
        assert op.verify_mirror()


def test_refresh_covers_expirations():
    """Under deferred sync the replica is never written between sync points
    (expiry skips its in-line clear too); ``verify_mirror`` refreshes it
    from the mirror and holds it equal (``TestDeferredSync``).  With the
    probe on, the JAX operator fails this check: its ``device_refresh``
    lists live panes before draining the delta, so a pane that only the
    delta holds stays at identity; the port drains first."""
    op = _port_op(device_sync="deferred", superbatch=4)
    for keys, vals, ts in BATCHES[:-1]:   # no end_input: panes expired
        op.process_batch(RecordBatch({"k": keys, "v": vals}, timestamps=ts))
        op.process_watermark(Watermark(int(ts.max()) - 1))
    assert op.pane_base > 0 and op._device_stale
    assert int(op._counts.sum()) == 0          # the replica lags
    assert op.verify_mirror()                  # flush, refresh, compare
    assert not op._device_stale
    assert op.fused_stats()["staged_pending"] == 0
    live = sum(int(e[0].sum()) for e in op._vmirror.values())
    assert int(op._counts.sum()) == live > 0
    before = op.phase_bytes["h2d_refresh"]
    assert before > 0
    op.device_refresh()                        # idempotent: a no-op
    assert op.phase_bytes["h2d_refresh"] == before

"""Port parity for the two-stage pipeline (``pipeline_depth > 0``): the port's
counterparts of ``tests/test_pipeline_equivalence.py``.

``flink_tpu_torch``'s ``WindowAggOperator`` with ``pipeline_depth=N`` runs
its hot stage on one worker thread, and ``native_shards > 1`` splits the C
pass over the C worker pool.  Both only move work: every case holds the port
at depths 1 and 2 to the port at depth 0, bit for bit (fire bytes, snapshot
arrays, counters), and to the JAX operator at the same depth.  The device
probe stays at its default ``"auto"`` in both packages, its verdict pinned
through the ``verdicts`` fixture of ``test_torch_calibration.py`` (which
puts every process-wide verdict back after the test), never measured.
"""

import threading
import time

import numpy as np
import pytest

import jax.numpy as jnp

from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.core.batch import Watermark as JaxWatermark
from flink_tpu.core.functions import RuntimeContext as JaxContext
from flink_tpu.core.functions import SumAggregator as JaxSum
from flink_tpu.operators.window_agg import WindowAggOperator as JaxOp
from flink_tpu.state.paging import PagingConfig as JaxPaging
from flink_tpu.windowing.assigners import TumblingEventTimeWindows as JaxTumbling
from flink_tpu_torch.core.batch import RecordBatch, Watermark
from flink_tpu_torch.core.functions import RuntimeContext, SumAggregator
from flink_tpu_torch.interop import snapshot_from_jax
from flink_tpu_torch.operators.base import StreamOperator
from flink_tpu_torch.operators.window_agg import WindowAggOperator
from flink_tpu_torch.state.paging import PagingConfig
from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows
from test_torch_calibration import _jax_x64, verdicts  # noqa: F401

SIDES = {"jax": (JaxOp, JaxTumbling, lambda: JaxSum(jnp.float32), JaxBatch,
                 JaxWatermark, JaxContext, JaxPaging),
         "port": (WindowAggOperator, TumblingEventTimeWindows, SumAggregator,
                  RecordBatch, Watermark, RuntimeContext, PagingConfig)}


def _mk(side, pipeline_depth=0, native_shards=1, native=True, paging=None,
        emit_tier="host", device_sync="scatter", window_ms=100, **kw):
    """The reference's ``_mk_op`` for either package (the port's on the
    CPU); ``paging`` is the keyword arguments of a ``PagingConfig``."""
    Op, Tumbling, Agg, _, _, Context, Paging = SIDES[side]
    if paging is not None:
        emit_tier = "device"
        kw["paging"] = Paging(**paging)
    if side == "port":
        kw["device"] = "cpu"
    op = Op(Tumbling.of(window_ms), Agg(), key_column="k", value_column="v",
            emit_tier=emit_tier,
            snapshot_source="mirror" if emit_tier == "host" else "device",
            device_sync=device_sync if emit_tier == "host" else "scatter",
            native_emit=native, pipeline_depth=pipeline_depth,
            native_shards=native_shards, **kw)
    op.open(Context())
    return op


def _digests(out):
    """Per fired batch: window, rows, and the bytes of the key and result
    columns (order included)."""
    return [(int(np.asarray(b.column("window_start"))[0]), len(b),
             np.asarray(b.column("k")).tobytes(),
             np.asarray(b.column("result")).tobytes())
            for b in out if "result" in b.columns]


def _counters(op):
    s, f = op.device_probe_stats(), op.fused_stats()
    return {"late_dropped": op.late_dropped,
            "num_keys": op.key_index.num_keys if op.key_index else 0,
            "watermark": op.watermark,
            "last_fired_window": op.last_fired_window,
            "probe": (s["enabled"], s["probe_hits"], s["probe_misses"]),
            "fused": (f["staged_batches"], f["flushes"],
                      f["scan_dispatches"], f["host_super_passes"]),
            "paging": op.paging_stats()}


def _assert_snap_equal(a, b):
    for k in ("pane_base", "max_pane", "last_fired_window", "watermark",
              "late_dropped", "P"):
        assert a[k] == b[k], k
    for k in ("panes", "counts"):
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert np.array_equal(a["key_index"]["reverse"],
                          b["key_index"]["reverse"])
    for x, y in zip(a["leaves"], b["leaves"], strict=True):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def _seeded_run(side, op, n_batches=12, nk=1500, b=4000, seed=11, snap_at=7,
                late_every=4):
    """The reference's ``_seeded_run``: per-batch watermarks, a mid-run
    snapshot, periodic late records, ``end_input``.  Returns (digests,
    snapshot in the port's format, counters)."""
    _, _, _, RB, WM, _, _ = SIDES[side]
    rng = np.random.default_rng(seed)
    out, snap = [], None
    with _jax_x64():
        for i in range(n_batches):
            keys = rng.integers(0, nk, b).astype(np.int64)
            vals = rng.random(b).astype(np.float32)
            ts = i * 50 + np.sort(rng.integers(0, 50, b)).astype(np.int64)
            if late_every and i % late_every == late_every - 1 and i > 0:
                ts[: b // 8] = max(0, (i - 3) * 50)
            out += op.process_batch(RB({"k": keys, "v": vals},
                                       timestamps=ts))
            out += op.process_watermark(WM(int(ts.max()) - 1))
            if i == snap_at:
                out += op.prepare_snapshot_pre_barrier()
                snap = op.snapshot_state()
        out += op.end_input()
        counters = _counters(op)
        op.close()
    if side == "jax":
        snap = snapshot_from_jax(snap)
    return _digests(out), snap, counters


def _assert_same(got, ref, what):
    assert got[0] == ref[0] and len(ref[0]) > 0, f"fire digests: {what}"
    _assert_snap_equal(got[1], ref[1])
    assert got[2] == ref[2], what


def _hold_depths(run, depths=(1, 2), jax_depths=(1, 2)):
    """``run(side, depth)`` at depth 0 is the reference: the port at each
    of ``depths`` and JAX at each of ``jax_depths`` must equal it."""
    ref = run("port", 0)
    for depth in depths:
        _assert_same(run("port", depth), ref, f"port depth {depth}")
    for depth in jax_depths:
        _assert_same(run("jax", depth), ref, f"JAX depth {depth}")
    return ref


# ---------------------------------------------------------------------------
# pipelining on vs off: bit-identical digests, snapshots, counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("probe", [True, False])
def test_pipeline_on_off_bit_identical_host_tier(verdicts, probe):
    """The C mirror, scatter sync, the probe lane on and off."""
    verdicts(probe=probe)
    ref = _hold_depths(lambda side, d: _seeded_run(
        side, _mk(side, pipeline_depth=d)))
    assert ref[2]["probe"][0] == int(probe)


def test_pipeline_numpy_mirror_fallback_identical(verdicts):
    verdicts(probe=True)
    _hold_depths(lambda side, d: _seeded_run(
        side, _mk(side, pipeline_depth=d, native=False)))


def test_pipeline_on_off_bit_identical_device_tier(verdicts):
    ref = _hold_depths(lambda side, d: _seeded_run(
        side, _mk(side, pipeline_depth=d, emit_tier="device")))
    assert ref[2]["probe"][0] == 0


def test_pipeline_on_off_bit_identical_deferred_sync(verdicts):
    verdicts(probe=True)
    _hold_depths(lambda side, d: _seeded_run(
        side, _mk(side, pipeline_depth=d, device_sync="deferred")))


def test_pipeline_with_the_fused_lane_bit_identical(verdicts):
    """Super-batches staged on the worker and flushed at the task thread's
    barriers: the scan lane (deferred sync, probe on)."""
    verdicts(probe=True)
    ref = _hold_depths(lambda side, d: _seeded_run(
        side, _mk(side, pipeline_depth=d, device_sync="deferred",
                  superbatch=4)), jax_depths=(2,))
    assert ref[2]["fused"][2] > 0


# ---------------------------------------------------------------------------
# native probe sharding: bit-identical at any shard count
# ---------------------------------------------------------------------------

SHARDED = dict(n_batches=6, nk=4096, b=1 << 15, late_every=0, snap_at=3)


def test_native_shards_bit_identical(verdicts):
    """Batches above the C pass's parallel threshold (2^14 rows), so the
    sharded phases run: slots, mirror cells and fire order equal one
    shard's, sharded and pipelined together too, and JAX's."""
    verdicts(probe=False)
    ref = _seeded_run("port", _mk("port", native_shards=1), **SHARDED)
    for shards in (2, 3):
        _assert_same(_seeded_run("port", _mk("port", native_shards=shards),
                                 **SHARDED), ref, f"{shards} shards")
    for side in ("port", "jax"):
        _assert_same(_seeded_run(side, _mk(side, pipeline_depth=2,
                                           native_shards=3), **SHARDED),
                     ref, f"{side} depth 2, 3 shards")


def test_native_shards_new_key_insert_order(verdicts):
    """Duplicate NEW keys inside one sharded batch get the slot ids the
    serial pass assigns (first occurrence in batch order)."""
    verdicts(probe=False)
    b = 1 << 15
    keys = np.arange(b, dtype=np.int64) % 977
    keys = np.concatenate([keys, keys[::-1]])
    vals = np.arange(keys.size, dtype=np.float32)
    ts = np.zeros(keys.size, np.int64)

    def run(side, shards, depth=0):
        _, _, _, RB, WM, _, _ = SIDES[side]
        op = _mk(side, native_shards=shards, pipeline_depth=depth)
        with _jax_x64():
            out = op.process_batch(RB({"k": keys, "v": vals}, timestamps=ts))
            out += op.process_watermark(WM(99))
            op.close()
        return _digests(out)

    ref = run("port", 1)
    assert len(ref) == 1
    assert run("port", 4) == run("port", 4, depth=2) == ref
    assert run("jax", 4) == ref


def test_native_shards_concurrent_callers_safe():
    """The C shard pool is process-wide: three threads sharding their own
    mirrors at once serialize their waves and keep every sum."""
    from flink_tpu_torch.state.keyindex import NativeKeyIndex
    from flink_tpu_torch.state.native_mirror import NativeWindowMirror

    agg = SumAggregator()
    results = [None] * 3

    def worker(seed, i):
        rng = np.random.default_rng(seed)
        idx = NativeKeyIndex(initial_capacity=1 << 15)
        nm = NativeWindowMirror.create(idx, agg.acc_spec(),
                                       agg.scatter_kind_leaves(),
                                       (np.float64,))
        B = 1 << 15
        total, count = 0.0, 0
        for _ in range(8):
            k = rng.integers(0, 1 << 15, B).astype(np.int64)
            v = rng.random(B).astype(np.float32)
            flat = np.empty(B, np.int32)
            nm.probe_update(k, np.zeros(B, np.int64), [v], pane_mod=16,
                            flat_out=flat, shards=3)
            total += float(v.astype(np.float64).sum())
            count += B
        _keys, counts, leaves = nm.fire(np.array([0]))
        results[i] = (float(np.asarray(leaves[0]).sum()), total,
                      int(np.asarray(counts).sum()), count)

    threads = [threading.Thread(target=worker, args=(s, i))
               for i, s in enumerate((1, 2, 3))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for got, want, cnt, n in results:
        assert abs(got - want) < 1e-6 * max(want, 1.0)
        assert cnt == n


# ---------------------------------------------------------------------------
# paging: 64k cap / 256k keys, pipelined vs serial
# ---------------------------------------------------------------------------

def _paged_run(side, pipeline_depth, n_keys=256 * 1024, cap=64 * 1024,
               seed=13):
    _, _, _, RB, WM, _, _ = SIDES[side]
    op = _mk(side, pipeline_depth=pipeline_depth, paging=dict(capacity=cap),
             window_ms=1000, initial_key_capacity=1 << 10)
    rng = np.random.default_rng(seed)
    out = []
    with _jax_x64():
        for w in range(2):
            keys = rng.permutation(n_keys).astype(np.int64)
            for lo in range(0, n_keys, 1 << 15):
                k = keys[lo: lo + (1 << 15)]
                v = (k % 17 + 1).astype(np.float32)
                out += op.process_batch(RB(
                    {"k": k, "v": v},
                    timestamps=np.full(k.size, w * 1000 + 10, np.int64)))
            out += op.process_watermark(WM(w * 1000 + 999))
        out += op.end_input()
        snap = op.snapshot_state()
        stats = op.paging_stats()
        op.close()
    if side == "jax":
        snap = snapshot_from_jax(snap)
    return _digests(out), snap, stats


def test_pipeline_with_paging_64k_cap_256k_keys(verdicts):
    """K_cap 64k under 256k live keys: pipelined and serial give the same
    fires (every spilled key fires), snapshots and counters, and JAX's
    pipelined run the same: the pager sees each batch's ids before any
    later batch can move an eviction."""
    ref = _paged_run("port", 0)
    assert ref[2]["spilled_keys"] == 256 * 1024 - 64 * 1024
    for side in ("port", "jax"):
        got = _paged_run(side, 2)
        assert got[0] == ref[0], side
        _assert_snap_equal(got[1], ref[1])
        assert got[2] == ref[2], side


# ---------------------------------------------------------------------------
# async fires with a pipeline
# ---------------------------------------------------------------------------

def test_async_fire_with_a_pipeline(verdicts):
    """The device tier's async fires: a pipelined run surfaces the serial
    run's fires at the same calls, bit for bit, and JAX's pipelined run
    the same fires in the same order."""
    def run(side, depth):
        _, _, _, RB, WM, _, _ = SIDES[side]
        op = _mk(side, pipeline_depth=depth, emit_tier="device",
                 async_fire=True)
        rng = np.random.default_rng(5)
        calls = []
        with _jax_x64():
            for i in range(10):
                keys = rng.integers(0, 800, 3000).astype(np.int64)
                vals = rng.random(3000).astype(np.float32)
                ts = i * 50 + np.sort(rng.integers(0, 50, 3000))
                calls.append(_digests(op.process_batch(
                    RB({"k": keys, "v": vals}, timestamps=ts))))
                calls.append(_digests(op.process_watermark(
                    WM(int(ts.max()) - 1))))
            calls.append(_digests(op.end_input()))
            op.close()
        return calls

    ref = run("port", 0)
    assert run("port", 1) == run("port", 2) == ref
    flat = [d for c in ref for d in c]
    assert len(flat) == 5
    assert [d for c in run("jax", 2) for d in c] == flat


# ---------------------------------------------------------------------------
# barriers and errors
# ---------------------------------------------------------------------------

def _one_batch(n=64, t=0):
    return RecordBatch({"k": np.arange(n, dtype=np.int64),
                        "v": np.ones(n, np.float32)},
                       timestamps=np.full(n, t, np.int64))


def test_flush_pipeline_base_noop_and_idempotent():
    assert StreamOperator().flush_pipeline() == []
    op = _mk("port", pipeline_depth=1)
    assert op.flush_pipeline() == []          # nothing in flight: no-op
    op.process_batch(_one_batch(256))
    op.flush_pipeline()
    op.flush_pipeline()                       # idempotent
    assert op.key_index.num_keys == 256       # stage completed at barrier
    assert not op._pipe_pending()
    op.close()
    assert op._pipe is None


#: every barrier of the operator, called after a failed stage
BARRIERS = {
    "flush_pipeline": lambda op, snap: op.flush_pipeline(),
    "process_batch": lambda op, snap: op.process_batch(_one_batch(t=10)),
    "process_watermark": lambda op, snap: op.process_watermark(
        Watermark(10 ** 6)),
    "prepare_snapshot_pre_barrier":
        lambda op, snap: op.prepare_snapshot_pre_barrier(),
    "snapshot_state": lambda op, snap: op.snapshot_state(),
    "restore_state": lambda op, snap: op.restore_state(snap),
    "verify_mirror": lambda op, snap: op.verify_mirror(),
    "device_refresh": lambda op, snap: op.device_refresh(),
    "end_input": lambda op, snap: op.end_input(),
    "reset_state": lambda op, snap: op.reset_state(),
}


@pytest.mark.parametrize("barrier", list(BARRIERS))
def test_stage_error_is_sticky_at_every_barrier(verdicts, barrier):
    """A stage failure re-raises at the next barrier and at every one after
    it (a monitoring caller cannot consume it), later stages are skipped,
    and ``close()`` raises it once more and clears it."""
    verdicts(probe=True)
    snap = _mk("port").snapshot_state()
    op = _mk("port", pipeline_depth=2, device_sync="deferred")
    ran = []

    def boom(*a, **kw):
        ran.append(a)
        raise RuntimeError("stage exploded")

    op._hot_stage = boom
    op.process_batch(_one_batch())
    deadline = time.monotonic() + 10
    while op._pipe_pending() and time.monotonic() < deadline:
        time.sleep(0.001)
    assert op._pipe._err is not None
    for _ in range(2):
        with pytest.raises(RuntimeError, match="stage exploded"):
            BARRIERS[barrier](op, snap)
    assert len(ran) == 1          # a stage after the error never ran
    assert op.paging_stats() is None and op.fused_stats()  # no barrier
    with pytest.raises(RuntimeError, match="stage exploded"):
        op.close()
    assert op.flush_pipeline() == []


def test_watermark_fast_path_never_defers_due_fires():
    """The fast path skips the barrier only when NO window newly passed: a
    watermark that crosses a window end fires at once, with the
    just-submitted stage's records in it."""
    op = _mk("port", pipeline_depth=3)
    out = []
    for w in range(4):
        keys = np.arange(100, dtype=np.int64)
        out += op.process_batch(RecordBatch(
            {"k": keys, "v": np.ones(100, np.float32)},
            timestamps=np.full(100, w * 100 + 50, np.int64)))
        out += op.process_watermark(Watermark(w * 100 + 99))
    fired = _digests(out)
    assert len(fired) == 4
    assert all(n == 100 for _w, n, _k, _r in fired)
    op.close()


def test_watermark_fast_path_keeps_stages_in_flight():
    """A watermark that passes no window end leaves a submitted stage in
    flight (no barrier), and the next fire still holds its rows."""
    op = _mk("port", pipeline_depth=2)
    gate = threading.Event()
    stage = op._hot_stage

    def held(*a):
        gate.wait(timeout=10)
        stage(*a)

    op.process_batch(_one_batch(10, t=5))
    assert op.process_watermark(Watermark(120)) != []      # fires window 0
    op._hot_stage = held
    op.process_batch(_one_batch(10, t=150))
    assert op.process_watermark(Watermark(160)) == []      # fast path
    assert op._pipe_pending()                              # still in flight
    gate.set()
    out = op.process_watermark(Watermark(199))
    assert [n for _w, n, _k, _r in _digests(out)] == [10]
    op.close()


# ---------------------------------------------------------------------------
# the upload sets
# ---------------------------------------------------------------------------

class _Token:
    """A stand-in CUDA event: ready only once ``done`` is set."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_staging_pool_never_hands_out_a_set_in_use():
    """A set whose token is not ready is never handed out again; at most 4
    sets are pooled per key (past that a fresh set is not kept); a set
    whose token completed is reused, token cleared."""
    op = _mk("port")
    leaves = [np.zeros(100, np.float32)]
    busy = []
    for _ in range(4):
        s = op._staging_acquire(128, np.int32, leaves)
        assert all(s is not b for b in busy)
        s.token = _Token()
        busy.append(s)
    extra = op._staging_acquire(128, np.int32, leaves)
    assert all(extra is not b for b in busy)
    extra.token = _Token()
    again = op._staging_acquire(128, np.int32, leaves)
    assert again is not extra and all(again is not b for b in busy)
    assert len(op._staging_pool[next(iter(op._staging_pool))]) == 4
    busy[2].token.done = True
    assert op._staging_acquire(128, np.int32, leaves) is busy[2]
    assert busy[2].token is None
    other = op._staging_acquire(256, np.int32, leaves)
    assert other.flat.shape == (256,) and len(op._staging_pool) == 2
    assert other.flat.dtype.itemsize == 4 and not other.flat.is_pinned()


def test_scatter_lane_uploads_through_the_pool(verdicts):
    """The host tier's scatter lane (C pass and numpy lookup) and the
    device tier fold every batch through one reused upload set on the CPU,
    and count the same h2d bytes as before (ids + values, B rows)."""
    verdicts(probe=False)
    for kw in (dict(), dict(native=False), dict(emit_tier="device")):
        op = _mk("port", **kw)
        for i in range(3):
            op.process_batch(_one_batch(1000, t=i))
        (sets,) = op._staging_pool.values()
        assert len(sets) == 1 and sets[0].flat.shape == (1024,)
        assert op.phase_bytes["h2d"] == 3 * 1000 * 8
        op.close()

"""Port parity for the device evicting lane: ``flink_tpu_torch.operators.
evicting_device`` against ``flink_tpu``'s ``DeviceEvictingWindowOperator``
on the CPU, on numpy-seeded batches.

Every case of ``tests/test_evicting_device.py`` runs through both
packages' device lanes in lockstep (:class:`Both`): every fire is compared
BIT FOR BIT (keys, results, window bounds, timestamps, dtypes), as are the
snapshots, the buffer capacity and the write cursor.  The reference test
holds JAX's device lane to its host lane (``EvictingWindowOperator``,
within f32 noise); the port has no host lane yet (ROADMAP Queue A item 8),
so its device lane is held to JAX's device lane instead, and the reference
tolerance check against JAX's host lane stays on the JAX side.  The
DataStream cases drive the operators directly (no DataStream API in the
port yet); their refusals are the operators' own ``ValueError``\\ s, whose
messages are JAX's.  A chaos wedge on ``append_step`` quarantines and
raises in both packages, and a restore recovers.
"""

import copy
import time

import numpy as np
import pytest

from flink_tpu.core import functions as jfn
from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.core.batch import Watermark as JaxWatermark
from flink_tpu.operators.evicting_device import \
    DeviceEvictingWindowOperator as JaxEvicting
from flink_tpu.operators.evicting_device import \
    device_evictor_supported as jax_supported
from flink_tpu.operators.evicting_window import EvictingWindowOperator
from flink_tpu.runtime import device_health as jdh
from flink_tpu.testing import chaos as jchaos
from flink_tpu.windowing import assigners as jas
from flink_tpu.windowing import evictors as jev
from flink_tpu_torch.core import functions as pfn
from flink_tpu_torch.core.batch import RecordBatch, Watermark
from flink_tpu_torch.interop import (evicting_snapshot_from_jax,
                                     evicting_snapshot_to_jax)
from flink_tpu_torch.operators.evicting_device import (
    DeviceEvictingWindowOperator, device_evictor_supported)
from flink_tpu_torch.ops import scatter as psc
from flink_tpu_torch.runtime import device_health as pdh
from flink_tpu_torch.testing import chaos as pchaos
from flink_tpu_torch.windowing import assigners as pas
from flink_tpu_torch.windowing import evictors as pev

SIDES = {
    "jax": dict(fn=jfn, Op=JaxEvicting, RB=JaxBatch, WM=JaxWatermark,
                win=jas, ev=jev, dh=jdh, chaos=jchaos, kw={}),
    "port": dict(fn=pfn, Op=DeviceEvictingWindowOperator, RB=RecordBatch,
                 WM=Watermark, win=pas, ev=pev, dh=pdh, chaos=pchaos,
                 kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _clean_monitors_and_injectors():
    """Neither package's process-wide monitor nor injector may leak."""
    prev = {s: S["dh"].get_monitor(create=False) for s, S in SIDES.items()}
    yield
    for s, S in SIDES.items():
        S["dh"].set_monitor(prev[s])
        S["chaos"].uninstall()


def _bits(a):
    a = np.asarray(a)
    if a.dtype == object:           # object cells by value, not by address
        return a.dtype.str, a.shape, tuple(a.tolist())
    return a.dtype.str, a.shape, a.tobytes()


def _view(elem):
    cols = tuple((c, _bits(elem.column(c))) for c in sorted(elem.columns))
    return cols, _bits(elem.timestamps)


def _snap_view(x):
    if isinstance(x, dict):
        return tuple((k, _snap_view(x[k])) for k in sorted(x))
    if isinstance(x, (list, tuple)):
        return tuple(_snap_view(v) for v in x)
    if isinstance(x, np.ndarray):
        return _bits(x)
    return x


def _evictor(side, spec):
    ev = SIDES[side]["ev"]
    kind, n = spec
    return ev.CountEvictor.of(n) if kind == "count" else ev.TimeEvictor.of(n)


def _agg(side, kind):
    fn = SIDES[side]["fn"]
    return {"sum": lambda: fn.SumAggregator(np.float32),
            "avg": lambda: fn.AvgAggregator(np.float32),
            "max": lambda: fn.MaxAggregator(np.float32),
            "count": lambda: fn.CountAggregator()}[kind]()


def make_op(side, evictor=("count", 5), agg="sum", assigner=None, **kw):
    S = SIDES[side]
    win = S["win"]
    asg = (win.TumblingEventTimeWindows.of(100) if assigner is None
           else win.SlidingEventTimeWindows.of(*assigner))
    op = S["Op"](asg, _evictor(side, evictor), _agg(side, agg),
                 key_column="k", value_column="v", **kw, **S["kw"])
    op.open(S["fn"].RuntimeContext())
    return op


class Both:
    """One device lane per package, driven in lockstep; every call's fires
    are compared bit for bit as they come."""

    def __init__(self, make):
        self.ops = {side: make(side) for side in SIDES}
        self.out = []

    @property
    def port(self):
        return self.ops["port"]

    def _both(self, call):
        outs = {side: call(side) for side in SIDES}
        assert [_view(e) for e in outs["jax"]] \
            == [_view(e) for e in outs["port"]]
        assert self.ops["jax"]._count == self.port._count
        assert self.ops["jax"]._C == self.port._C
        self.out += outs["port"]
        return outs["port"]

    def batch(self, keys, vals, ts):
        keys = np.asarray(keys)
        if keys.dtype != object:
            keys = keys.astype(np.int64)
        return self._both(lambda side: self.ops[side].process_batch(
            SIDES[side]["RB"]({"k": keys,
                               "v": np.asarray(vals, np.float32)},
                              timestamps=np.asarray(ts, np.int64))))

    def wm(self, t):
        return self._both(lambda side: self.ops[side].process_watermark(
            SIDES[side]["WM"](t)))

    def end(self):
        return self._both(lambda side: self.ops[side].end_input())

    def run(self, batches, wm_each=True):
        for keys, vals, ts in batches:
            self.batch(keys, vals, ts)
            if wm_each:
                self.wm(int(np.max(ts)) - 1)
        self.end()
        return self

    def snapshot(self):
        snaps = {side: op.snapshot_state() for side, op in self.ops.items()}
        assert _snap_view(snaps["jax"]) == _snap_view(snaps["port"])
        return snaps

    def rows(self):
        out = []
        for b in self.out:
            for i in range(len(b)):
                k = np.asarray(b.column("k"))[i]
                out.append((k if isinstance(k, str) else int(k),
                            int(np.asarray(b.column("window_start"))[i]),
                            round(float(np.asarray(b.column("result"))[i]),
                                  4)))
        return sorted(out)


def _batches(seed=0, nb=6, n=400, keys=23, span=120):
    """The reference test's batches."""
    rng = np.random.default_rng(seed)
    out = []
    t = 0
    for _ in range(nb):
        ts = t + np.sort(rng.integers(0, span, n))
        out.append((rng.integers(0, keys, n), rng.random(n), ts))
        t += span
    return out


def _host_sum_apply(key, window, rows):
    return {"k": key, "result": float(sum(r["v"] for r in rows)),
            "window_start": window.start, "window_end": window.end}


def _jax_host_rows(evictor, batches, assigner=None):
    """JAX's host lane (the reference test's comparison)."""
    op = EvictingWindowOperator(
        assigner or jas.TumblingEventTimeWindows.of(100), evictor,
        key_column="k", apply_fn=_host_sum_apply)
    op.open(jfn.RuntimeContext())
    out = []
    for keys, vals, ts in batches:
        out += op.process_batch(JaxBatch(
            {"k": np.asarray(keys, np.int64),
             "v": np.asarray(vals, np.float32)},
            timestamps=np.asarray(ts, np.int64)))
        out += op.process_watermark(JaxWatermark(int(np.max(ts)) - 1))
    out += op.end_input()
    return sorted((int(np.asarray(b.column("k"))[i]),
                   int(np.asarray(b.column("window_start"))[i]),
                   round(float(np.asarray(b.column("result"))[i]), 4))
                  for b in out if hasattr(b, "columns")
                  for i in range(len(b)))


def _assert_host_equivalent(dev, host):
    """The reference test's tolerance: same (key, window) sets, results
    equal to f32 summation-order noise (rtol = atol = 1e-4)."""
    assert [(k, w) for k, w, _ in dev] == [(k, w) for k, w, _ in host] and dev
    np.testing.assert_allclose([v for *_, v in dev], [v for *_, v in host],
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the cases of tests/test_evicting_device.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("evictor", [("count", 5), ("time", 30)])
def test_tier_equivalence_tumbling(evictor):
    batches = _batches()
    h = Both(lambda s: make_op(s, evictor)).run(batches)
    _assert_host_equivalent(h.rows(), _jax_host_rows(
        copy.deepcopy(_evictor("jax", evictor)), batches))


def test_tier_equivalence_sliding_panes():
    batches = _batches(seed=2)
    h = Both(lambda s: make_op(s, ("count", 3),
                               assigner=(200, 100))).run(batches)
    _assert_host_equivalent(h.rows(), _jax_host_rows(
        jev.CountEvictor.of(3), batches,
        jas.SlidingEventTimeWindows.of(200, 100)))


def test_count_evictor_keeps_last_n():
    h = Both(lambda s: make_op(s, ("count", 2)))
    h.run([([1] * 6, [1, 2, 3, 4, 5, 6], [10, 20, 30, 40, 50, 60])])
    assert h.rows() == [(1, 0, 11.0)]


def test_time_evictor_trailing_span():
    h = Both(lambda s: make_op(s, ("time", 15)))
    h.run([([7] * 4, [1, 2, 3, 4], [10, 20, 40, 50])])
    assert h.rows() == [(7, 0, 7.0)]


def test_avg_and_max_aggregates():
    h = Both(lambda s: make_op(s, ("count", 3), agg="avg"))
    h.run([([1] * 5, [10, 20, 30, 40, 50], [1, 2, 3, 4, 5])])
    assert h.rows() == [(1, 0, 40.0)]
    h2 = Both(lambda s: make_op(s, ("time", 100), agg="max"))
    h2.run([([1, 1], [5, 3], [1, 2])])
    assert h2.rows() == [(1, 0, 5.0)]


@pytest.mark.parametrize("restore_into", ["same", "jax_to_port",
                                          "port_to_jax"])
def test_snapshot_restore_mid_window(restore_into):
    """A mid-window snapshot restores into its own package or across
    (``interop.py``) and the rest equals the uninterrupted run."""
    ev = ("count", 4)
    batches = _batches(seed=5, nb=4)
    full = Both(lambda s: make_op(s, ev)).run(batches).rows()
    h = Both(lambda s: make_op(s, ev))
    for keys, vals, ts in batches[:2]:
        h.batch(keys, vals, ts)
        h.wm(int(np.max(ts)) - 1)
    snaps = h.snapshot()
    if restore_into == "jax_to_port":
        snaps["port"] = evicting_snapshot_from_jax(snaps["jax"])
    elif restore_into == "port_to_jax":
        snaps["jax"] = evicting_snapshot_to_jax(snaps["port"])
    h2 = Both(lambda s: make_op(s, ev))
    for side, op in h2.ops.items():
        op.restore_state(snaps[side])
    assert h2.port._count == h2.ops["jax"]._count    # the padded length
    h2.run(batches[2:])
    assert h.rows() and sorted(h.rows() + h2.rows()) == full


def test_buffer_compaction_bounds_growth():
    h = Both(lambda s: make_op(s, ("count", 2), initial_capacity=256))
    t = 0
    for i in range(40):                     # 40 * 64 rows >> 256
        ts = t + np.sort(np.random.default_rng(i).integers(0, 100, 64))
        h.batch(np.arange(64, dtype=np.int64) % 5, np.ones(64), ts)
        h.wm(t + 99)
        t += 100
    assert h.port._C <= 4096 and h.port._C == h.ops["jax"]._C
    h.snapshot()


def test_api_routing_and_unsupported():
    """JAX routes ``.evictor(Count).aggregate(...)`` to the device lane in
    its DataStream API; the port drives the lane directly (no DataStream
    API yet): the same stream, results capped by the evictor, bit for bit.
    The unsupported evictor raises at the operator with JAX's message."""
    n = 3000
    rng = np.random.default_rng(1)
    keys, vals = rng.integers(0, 9, n), rng.random(n)
    ts = np.sort(rng.integers(0, 1000, n))
    h = Both(lambda s: make_op(s, ("count", 3)))
    h.batch(keys, vals, ts)
    h.wm(int(ts.max()) - 1)
    h.end()
    assert h.rows() and all(v <= 3.0 for *_, v in h.rows())
    for side, S in SIDES.items():
        with pytest.raises(ValueError, match="device evictor lane"):
            S["Op"](S["win"].TumblingEventTimeWindows.of(250),
                    S["ev"].DeltaEvictor(1.0, lambda r: r),
                    _agg(side, "sum"), key_column="k", value_column="v",
                    **S["kw"])
    for supported in (device_evictor_supported, jax_supported):
        assert not supported(pev.DeltaEvictor(1.0, lambda r: r),
                             pfn.SumAggregator(np.float32))
    assert device_evictor_supported(pev.CountEvictor.of(2),
                                    pfn.SumAggregator(np.float32))
    assert not device_evictor_supported(
        pev.CountEvictor.of(2), pfn.LambdaReduce(lambda a, b: a + b, 0.0))


def test_evictor_count_and_session_guard():
    """``count()`` with an evictor is capped at its n, bit for bit; a
    session gap (no panes) and an aggregate without scatter kinds raise at
    the operator in both packages, with JAX's messages."""
    n = 2000
    rng = np.random.default_rng(4)
    keys, vals = rng.integers(0, 5, n), rng.random(n)
    ts = np.sort(rng.integers(0, 1000, n))
    h = Both(lambda s: make_op(s, ("count", 7), agg="count",
                               assigner=(500, 500)))
    h.batch(keys, vals, ts)
    h.wm(int(ts.max()) - 1)
    h.end()
    assert h.rows() and all(v <= 7 for *_, v in h.rows())
    for side, S in SIDES.items():
        with pytest.raises(ValueError, match="pane-based assigner"):
            S["Op"](S["win"].SessionGap(100), _evictor(side, ("count", 2)),
                    _agg(side, "count"), key_column="k", value_column="v",
                    **S["kw"])
        with pytest.raises(ValueError, match="declared scatter kinds"):
            S["Op"](S["win"].TumblingEventTimeWindows.of(100),
                    _evictor(side, ("count", 2)),
                    S["fn"].LambdaReduce(lambda a, b: a + b, 0.0),
                    key_column="k", value_column="v", **S["kw"])


# ---------------------------------------------------------------------------
# beyond the reference file
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("evictor", [("count", 5), ("time", 30)])
@pytest.mark.parametrize("agg", ["sum", "avg", "max"])
@pytest.mark.parametrize("assigner", [None, (200, 100)])
def test_evictors_aggregates_windows_bit_for_bit(evictor, agg, assigner):
    """Both evictors x sum/avg/max x tumbling/sliding, with allowed
    lateness and late drops, key growth past the initial key capacity and
    buffer growth and compaction: fires and snapshots bit for bit."""
    rng = np.random.default_rng(11)
    h = Both(lambda s: make_op(s, evictor, agg=agg, assigner=assigner,
                               allowed_lateness_ms=50, initial_capacity=512,
                               initial_key_capacity=64))
    t = 0
    for i in range(10):
        n = 300 + 37 * i
        keys = rng.integers(0, 40 + 30 * i, n)
        ts = t + np.sort(rng.integers(-300, 150, n))
        h.batch(keys, (rng.random(n) * 8 - 4), ts)
        h.wm(t + 140)
        if i == 6:
            h.snapshot()
        t += 150
    h.end()
    assert h.out and h.port.late_dropped == h.ops["jax"].late_dropped > 0
    assert h.port._K > 64


def test_fire_steps_count_one_ordered_fold_each():
    """Each fire step folds its window through one ``ordered_fold_counts``
    call (on the CPU the plain version: no launch is counted)."""
    calls = []
    real = psc.ordered_fold_counts

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)
    import flink_tpu_torch.operators.evicting_device as ped
    ped.ordered_fold_counts = counting
    try:
        h = Both(lambda s: make_op(s, ("count", 2))).run(_batches(nb=3))
    finally:
        ped.ordered_fold_counts = real
    assert len(calls) == h.port.fire_steps >= 3
    assert h.port.buffer_bytes == 16 * h.port._C


def test_object_keys_raise():
    """String keys (the object-key slice): fires bit for bit against JAX,
    and a mid-stream snapshot restores across the packages both ways."""
    batches = [(np.char.add("u", k.astype(str)).astype(object), v, ts)
               for k, v, ts in _batches(seed=8, nb=4)]
    ev = ("count", 3)
    full = Both(lambda s: make_op(s, ev)).run(batches).rows()
    h = Both(lambda s: make_op(s, ev))
    for keys, vals, ts in batches[:2]:
        h.batch(keys, vals, ts)
        h.wm(int(np.max(ts)) - 1)
    snaps = h.snapshot()
    assert snaps["port"]["key_index_kind"] == "ObjectKeyIndex"
    snaps = {"port": evicting_snapshot_from_jax(snaps["jax"]),
             "jax": evicting_snapshot_to_jax(snaps["port"])}
    h2 = Both(lambda s: make_op(s, ev))
    for side, op in h2.ops.items():
        op.restore_state(snaps[side])
    h2.run(batches[2:])
    assert h.rows() and sorted(h.rows() + h2.rows()) == full


def _fast_monitor(side):
    dh = SIDES[side]["dh"]
    cfg = dh.WatchdogConfig(
        deadline_floor_s=0.25, first_dispatch_grace_s=0.25,
        backoff_initial_s=0.001, backoff_max_s=0.01,
        probe_backoff_initial_s=0.02, probe_backoff_max_s=0.1)
    mon = dh.DeviceHealthMonitor(cfg, heal_async=False)
    dh.set_monitor(mon)
    return mon


def _wedge_scenario(side, batches, at):
    """Batches through one package's lane under a fast monitor with a wedge
    at the ``at``-th dispatch: returns (the batch index that raised, the
    monitor's counters, the dispatch labels, the snapshot taken before)."""
    S = SIDES[side]
    mon = _fast_monitor(side)
    inj = S["chaos"].FaultInjector(seed=1)
    sched = inj.inject("device.dispatch", S["chaos"].WedgedDevice(at=at))
    op = make_op(side, ("count", 3))
    raised, snap = None, None
    with S["chaos"].installed(inj):
        for i, (keys, vals, ts) in enumerate(batches):
            if i == at - 1:
                snap = op.snapshot_state()
            t0 = time.monotonic()
            try:
                op.process_batch(S["RB"](
                    {"k": np.asarray(keys, np.int64),
                     "v": np.asarray(vals, np.float32)},
                    timestamps=np.asarray(ts, np.int64)))
            except S["dh"].DeviceQuarantinedError:
                assert time.monotonic() - t0 < 5.0
                raised = i
                break
            op.process_watermark(S["WM"](int(np.max(ts)) - 1))
    sched.heal()
    st = mon.status()
    return (raised, st["quarantines"], st["watchdog_timeouts"], st["state"],
            sorted(st["dispatch_labels"])), snap


def test_append_wedge_quarantines_and_raises_as_in_jax():
    """A wedge on the append's dispatch quarantines the tier and fails the
    operator (no host twin to degrade onto), in both packages alike, under
    the label ``evicting-window-device.append_step``; the snapshot before
    it restores into a fresh operator under a healthy monitor and finishes
    as a clean run."""
    batches = _batches(seed=7, nb=6)
    results = {side: _wedge_scenario(side, batches, at=4) for side in SIDES}
    assert results["port"][0] == results["jax"][0]
    raised, quarantines, timeouts, state, labels = results["port"][0]
    assert raised == 3 and quarantines == 1 and timeouts == 1
    assert labels == ["evicting-window-device.append_step"]
    assert _snap_view(results["port"][1]) == _snap_view(results["jax"][1])
    for side in SIDES:
        SIDES[side]["dh"].set_monitor(None)
    clean = Both(lambda s: make_op(s, ("count", 3))).run(batches).rows()
    h = Both(lambda s: make_op(s, ("count", 3)))
    for side, op in h.ops.items():
        op.restore_state(results[side][1])
    h.run(batches[3:])
    pre = Both(lambda s: make_op(s, ("count", 3)))
    for keys, vals, ts in batches[:3]:
        pre.batch(keys, vals, ts)
        pre.wm(int(np.max(ts)) - 1)
    assert sorted(pre.rows() + h.rows()) == clean

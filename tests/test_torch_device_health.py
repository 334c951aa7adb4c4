"""Port parity for the device watchdog: ``flink_tpu_torch.runtime.
device_health`` and the quarantine paths of the port's ``WindowAggOperator``
against ``flink_tpu``'s (the port's counterparts of
``tests/test_device_health.py``, the probe-lane wedge of
``tests/test_device_keyindex.py`` and the scan-lane wedge of
``tests/test_fused_step.py``).

Each package has its own monitor and its own fault injector; a scenario
runs the same schedule with the same seed through both, on the same
batches, and holds the port to JAX: fire bytes per window, the
mid-quarantine snapshot, ``device_health_stats()``, ``hot_dispatches``,
the monitor's counters and the injector's history.  The port is also held
to its own clean run: bit for bit where the values sum exactly, and to
rtol 1e-6 with random f32 values on the device tier (a degraded device tier
folds into the f64 host mirror, and re-promotion uploads those sums as
f32, in both packages).

The autouse fixture puts both packages' monitors and injectors back after
every test, and the ``verdicts`` fixture of ``test_torch_calibration.py``
pins and restores every process-wide calibration verdict, so nothing here
leaks into another test of the same worker.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.core.batch import Watermark as JaxWatermark
from flink_tpu.core.functions import RuntimeContext as JaxContext
from flink_tpu.core.functions import SumAggregator as JaxSum
from flink_tpu.operators.window_agg import WindowAggOperator as JaxOp
from flink_tpu.runtime import device_health as jdh
from flink_tpu.state.paging import PagingConfig as JaxPaging
from flink_tpu.testing import chaos as jchaos
from flink_tpu.utils import transport as jtransport
from flink_tpu.windowing.assigners import TumblingEventTimeWindows as JaxTumbling
from flink_tpu_torch.core.batch import RecordBatch, Watermark
from flink_tpu_torch.core.functions import RuntimeContext, SumAggregator
from flink_tpu_torch.interop import snapshot_from_jax, snapshot_to_jax
from flink_tpu_torch.operators import window_agg as pwa
from flink_tpu_torch.operators.window_agg import WindowAggOperator
from flink_tpu_torch.runtime import device_health as pdh
from flink_tpu_torch.state.paging import PagingConfig
from flink_tpu_torch.testing import chaos as pchaos
from flink_tpu_torch.utils import transport as ptransport
from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows
from test_torch_calibration import _jax_x64, verdicts  # noqa: F401

pytestmark = pytest.mark.chaos

WINDOW_MS = 1000

SIDES = {
    "jax": dict(dh=jdh, chaos=jchaos, Op=JaxOp, Tumbling=JaxTumbling,
                Agg=lambda: JaxSum(jnp.float32), RB=JaxBatch,
                WM=JaxWatermark, Ctx=JaxContext, Paging=JaxPaging,
                transport=jtransport),
    "port": dict(dh=pdh, chaos=pchaos, Op=WindowAggOperator,
                 Tumbling=TumblingEventTimeWindows, Agg=SumAggregator,
                 RB=RecordBatch, WM=Watermark, Ctx=RuntimeContext,
                 Paging=PagingConfig, transport=ptransport),
}

#: monitor counters that do not depend on timing (near misses do)
COUNTERS = ("dispatches", "quarantines", "heals", "watchdog_timeouts",
            "transient_retries", "oom_pageouts")


@pytest.fixture(autouse=True)
def _clean_monitors_and_injectors(verdicts):  # noqa: F811
    """Neither package's monitor nor injector may leak across tests (the
    monitors are process-wide by design); every verdict is pinned (not
    measured) and restored by ``verdicts``."""
    prev = {s: S["dh"].get_monitor(create=False) for s, S in SIDES.items()}
    yield
    for s, S in SIDES.items():
        S["dh"].set_monitor(prev[s])
        S["chaos"].uninstall()


def _fast_monitor(side, **kw):
    """The reference tests' fast monitor, for one package."""
    dh = SIDES[side]["dh"]
    cfg = dh.WatchdogConfig(
        deadline_floor_s=kw.pop("deadline_floor_s", 0.25),
        first_dispatch_grace_s=kw.pop("first_dispatch_grace_s", 30.0),
        backoff_initial_s=0.001, backoff_max_s=0.01,
        probe_backoff_initial_s=0.02, probe_backoff_max_s=0.1)
    mon = dh.DeviceHealthMonitor(cfg, **kw)
    dh.set_monitor(mon)
    return mon


def _counters(mon):
    st = mon.status()
    return ({k: st[k] for k in COUNTERS}, st["state"], st["dispatch_labels"])


def _op(side, emit_tier="device", window_ms=WINDOW_MS, paging_cap=0,
        device_probe="off", device_sync="scatter", agg=None, **kw):
    """One package's operator, every calibrated setting pinned (the port's
    on the CPU)."""
    S = SIDES[side]
    if paging_cap:
        kw["paging"] = S["Paging"](capacity=paging_cap)
    if side == "port":
        kw["device"] = "cpu"
    kw.setdefault("native_emit", True)
    op = S["Op"](S["Tumbling"].of(window_ms), agg or S["Agg"](),
                 key_column="k", value_column="v", emit_tier=emit_tier,
                 snapshot_source="mirror" if emit_tier == "host" else "device",
                 device_sync=device_sync if emit_tier == "host" else "scatter",
                 device_probe=device_probe, native_shards=1, **kw)
    op.open(S["Ctx"]())
    return op


def _batches(n=20, b=256, keys=37, seed=5, values="ones", step_ms=None):
    """The reference tests' batches: two batches per window; ``values``
    "ones", "quarters" (exact sums in f32) or "random" f32."""
    rng = np.random.default_rng(seed)
    step_ms = step_ms or WINDOW_MS // 2
    out = []
    for i in range(n):
        k = rng.integers(0, keys, b).astype(np.int64)
        if values == "ones":
            v = np.ones(b, np.float32)
        elif values == "quarters":
            v = (rng.integers(0, 64, b) / 4).astype(np.float32)
        else:
            v = rng.random(b).astype(np.float32)
        ts = i * step_ms + np.sort(rng.integers(0, step_ms, b)).astype(
            np.int64)
        out.append((k, v, ts))
    return out


def _by_window(out):
    """window start -> (keys, results), each window's rows merged (a paged
    fire emits its resident and spilled keys apart) and sorted by key."""
    parts = {}
    for b in out:
        if "result" not in b.columns:
            continue
        w = int(np.asarray(b.column("window_start"))[0])
        parts.setdefault(w, []).append(b)
    merged = {}
    for w, bs in parts.items():
        k = np.concatenate([np.asarray(b.column("k")) for b in bs])
        r = np.concatenate([np.asarray(b.column("result")) for b in bs])
        order = np.argsort(k, kind="stable")
        merged[w] = (k[order], r[order])
    return merged


def _assert_fires_equal(a, b, what, rtol=None, same_dtype=True):
    """Same windows and keys; values bit for bit (``same_dtype=False``:
    equal values, as a degraded device tier fires the f64 mirror's sums,
    in both packages), or to ``rtol``."""
    assert sorted(a) == sorted(b) and a, f"{what}: windows differ"
    for w in a:
        (ka, ra), (kb, rb) = a[w], b[w]
        assert np.array_equal(ka, kb), f"{what} window {w}: keys differ"
        if rtol is None and not same_dtype:
            assert np.array_equal(ra.astype(np.float64),
                                  rb.astype(np.float64)), \
                f"{what} window {w}: values differ"
        elif rtol is None:
            assert ra.dtype == rb.dtype and ra.tobytes() == rb.tobytes(), \
                f"{what} window {w}: values differ in their bits"
        else:
            np.testing.assert_allclose(ra, rb, rtol=rtol, atol=0,
                                       err_msg=f"{what} window {w}")


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


class Run:
    """What one driven operator left: fires by window, the mid-run
    snapshot (port format), whether it was taken degraded, the operator's
    and the monitor's counters, the injector's history."""

    def __init__(self, fires, snap, snap_degraded, op, mon, history):
        self.fires = fires
        self.snap = snap
        self.snap_degraded = snap_degraded
        self.health = op.device_health_stats()
        self.hot = op.fused_stats()["hot_dispatches"]
        self.paging = op.paging_stats()
        self.degraded = op._degraded
        self.monitor = _counters(mon) if mon is not None else None
        self.history = history

    def parity(self):
        """Everything that must equal the other package's."""
        return (self.health, self.hot, self.paging, self.snap_degraded,
                self.monitor, self.history)


def _drive(side, op, batches, schedule=None, heal_at=None, snap_at=None,
           repromote_at=None, start=0, seed=1):
    """Batches from ``start`` + a watermark after each, under ``schedule``
    (a function of the package's chaos module, or None); ``heal_at``:
    heal the schedule and probe; ``snap_at``: snapshot (after the
    pre-barrier); ``repromote_at``: the next safe point.  Returns a Run."""
    S = SIDES[side]
    ch = S["chaos"]
    inj = ch.FaultInjector(seed=seed)
    sched = (inj.inject("device.dispatch", schedule(ch))
             if schedule is not None else None)
    out, snap, snap_degraded = [], None, None
    with _jax_x64(), ch.installed(inj):
        for i, (k, v, ts) in enumerate(batches):
            if i < start:
                continue
            out += op.process_batch(S["RB"]({"k": k, "v": v},
                                            timestamps=ts))
            out += op.process_watermark(S["WM"](int(ts.max()) - 1))
            if i == snap_at:
                out += op.prepare_snapshot_pre_barrier()
                snap = op.snapshot_state()
                snap_degraded = op._degraded
            if i == heal_at:
                sched.heal()
                assert S["dh"].get_monitor().probe_now()
            if i == repromote_at:
                out += op.prepare_snapshot_pre_barrier()
        out += op.end_input()
    if side == "jax" and snap is not None:
        snap = snapshot_from_jax(snap)
    run = Run(_by_window(out), snap, snap_degraded, op,
              S["dh"].get_monitor(create=False),
              inj.history("device.dispatch"))
    op.close() if hasattr(op, "close") else None
    return run


def _wedge(at):
    return lambda ch: ch.WedgedDevice(at=at)


# ---------------------------------------------------------------------------
# the monitor, against JAX's
# ---------------------------------------------------------------------------

_MESSAGES = [
    "RESOURCE_EXHAUSTED: out of memory",
    "UNAVAILABLE: socket closed",
    "INTERNAL: stream terminated",
    "DEADLINE_EXCEEDED: rpc",
    "connection reset by peer",
    "bad operand shape",
    "shapes (3,) and (4,)",
    "unknown key column x",
    "operation aborted by user",
    "boom",
    "a bloom filter overflowed",
    "the oom killer ran",
    # torch.cuda.OutOfMemoryError's own wording
    "CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; 79.10 GiB "
    "total capacity)",
]


@pytest.mark.parametrize("exc_type", [RuntimeError, ValueError, TypeError,
                                      KeyError])
@pytest.mark.parametrize("msg", _MESSAGES)
def test_classify_failure_matches_jax(msg, exc_type):
    got = pdh.classify_failure(exc_type(msg))
    assert got == jdh.classify_failure(exc_type(msg))
    assert pdh.classify_failure(pchaos.InjectedFault(msg)) == \
        jdh.classify_failure(jchaos.InjectedFault(msg))


def test_torch_out_of_memory_error_classifies_as_oom():
    """The exception a failed CUDA allocation raises reads as OOM (its
    message says "out of memory"), in both classifiers."""
    err = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 MiB")
    assert pdh.classify_failure(err) == pdh.OOM == jdh.classify_failure(err)
    assert pdh.classify_failure(torch.OutOfMemoryError("out of memory")) \
        == pdh.OOM


def _wedged_monitor_scenario(side):
    mon = _fast_monitor(side, heal_async=False, first_dispatch_grace_s=0.25)
    S = SIDES[side]
    ch, dh = S["chaos"], S["dh"]
    inj = ch.FaultInjector(seed=1)
    sched = inj.inject("device.dispatch", ch.WedgedDevice(at=1))
    ran = []
    with ch.installed(inj):
        t0 = time.monotonic()
        with pytest.raises(dh.DeviceQuarantinedError):
            mon.run_guarded(lambda: ran.append(1))
        assert time.monotonic() - t0 < 5.0   # bounded, not forever
    assert mon.quarantined and sched.wedged_once
    sched.heal()
    time.sleep(0.1)
    assert ran == []          # the abandoned lane skipped the thunk
    t0 = time.monotonic()
    with pytest.raises(dh.DeviceQuarantinedError):
        mon.run_guarded(lambda: 1)
    assert time.monotonic() - t0 < 0.1
    return _counters(mon), mon.last_failure, inj.history("device.dispatch")


def test_watchdog_fires_under_wedged_device():
    port = _wedged_monitor_scenario("port")
    assert port[0][0]["watchdog_timeouts"] == 1
    assert port[0][0]["quarantines"] == 1
    assert port == _wedged_monitor_scenario("jax")


def _retry_scenario(side, k):
    mon = _fast_monitor(side, heal_async=False)
    S = SIDES[side]
    inj = S["chaos"].FaultInjector(seed=2)
    inj.inject("device.dispatch", S["chaos"].FailTimes(k))
    with S["chaos"].installed(inj):
        try:
            res = mon.run_guarded(lambda: "ok")
        except S["dh"].DeviceQuarantinedError:
            res = "quarantined"
    return res, _counters(mon), inj.history("device.dispatch")


@pytest.mark.parametrize("k", [1, 2, 3, 4, 50])
def test_transient_retries_and_their_exhaustion_match_jax(k):
    """Up to 3 transient failures retry under backoff; the 4th
    quarantines."""
    port = _retry_scenario("port", k)
    assert port[0] == ("ok" if k <= 3 else "quarantined")
    assert port[1][0]["transient_retries"] == min(k, 3)
    assert port == _retry_scenario("jax", k)


def _healer_scenario(side):
    mon = _fast_monitor(side, heal_async=True, first_dispatch_grace_s=0.25)
    S = SIDES[side]
    inj = S["chaos"].FaultInjector(seed=4)
    sched = inj.inject("device.dispatch", S["chaos"].WedgedDevice(at=1))
    with S["chaos"].installed(inj):
        with pytest.raises(S["dh"].DeviceQuarantinedError):
            mon.run_guarded(lambda: 1)
        time.sleep(0.15)
        assert mon.quarantined, "probe must fail while wedged"
        sched.heal()
        deadline = time.monotonic() + 5.0
        while mon.quarantined and time.monotonic() < deadline:
            time.sleep(0.01)
    assert mon.healthy
    c = _counters(mon)[0]
    return c["heals"], c["quarantines"]


def test_background_healer_heals_on_schedule_heal():
    assert _healer_scenario("port") == (1, 1) == _healer_scenario("jax")


@pytest.mark.parametrize("samples", [[], [(1.0, 0.05)] * 3,
                                     [(2.0, 0.01), (1.0, 0.2), (0.6, 0.3)]])
@pytest.mark.parametrize("mb", [0.0, 0.001, 100.0, 5000.0])
def test_deadline_follows_the_ports_transport_samples(samples, mb):
    """The deadline reads the port's own transport calibration; the same
    samples give JAX's deadline."""
    got = {}
    for side, S in SIDES.items():
        mon = S["dh"].DeviceHealthMonitor(S["dh"].WatchdogConfig(
            deadline_floor_s=1.0, deadline_multiplier=10.0))
        S["transport"].reset()
        for m, s in samples:
            S["transport"].record_dispatch_cost(m, s)
        got[side] = mon.deadline_s(mb)
    assert got["port"] == got["jax"]
    if samples == [(1.0, 0.05)] * 3 and mb == 100.0:
        assert got["port"] == pytest.approx(50.0)   # 100 MB x 50 ms x 10


def test_watchdog_floor_is_read_at_construction(monkeypatch):
    monkeypatch.setenv("FLINK_TPU_WATCHDOG_FLOOR_S", "7.5")
    assert pdh.WatchdogConfig().deadline_floor_s == 7.5 == \
        jdh.WatchdogConfig().deadline_floor_s
    monkeypatch.delenv("FLINK_TPU_WATCHDOG_FLOOR_S")
    assert pdh.WatchdogConfig().deadline_floor_s == 120.0


@pytest.mark.parametrize("side", ["port", "jax"])
def test_salvage_read_is_deadline_bounded(side):
    """A read that cannot complete within the salvage deadline raises, and
    the task thread is not held."""
    mon = _fast_monitor(side, heal_async=False)
    hang = threading.Event()
    t0 = time.monotonic()
    with pytest.raises(SIDES[side]["dh"].DeviceQuarantinedError,
                       match="salvage"):
        mon.run_salvage(hang.wait, deadline_s=0.2, label="migration")
    assert time.monotonic() - t0 < 2.0
    assert mon.counters["watchdog_timeouts"] == 1
    assert mon.counters["quarantines"] == 0
    hang.set()   # release the sacrificed lane thread


@pytest.mark.parametrize("side", ["port", "jax"])
def test_lane_threads_pruned_when_task_threads_die(side):
    mon = _fast_monitor(side, heal_async=False)

    def _dispatch():
        mon.run_guarded(lambda: 1)

    for _ in range(5):
        t = threading.Thread(target=_dispatch)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    mon.run_guarded(lambda: 1)   # lookup prunes the dead threads' lanes
    assert len(mon._lanes) == 1


def test_subprocess_probe_never_reports_a_cpu_as_healthy():
    """The healer's probe launches on ``cuda`` in a fresh process: True
    exactly where a card is visible (never here, on the CPU)."""
    assert pdh.probe_backend_subprocess(timeout_s=120) is \
        torch.cuda.is_available()
    assert "device='cuda'" in pdh.PROBE_CODE


def test_chaos_aware_probe_reads_the_schedule():
    inj = pchaos.FaultInjector(seed=9)
    sched = inj.inject("device.dispatch", pchaos.WedgedDevice(at=1))
    with pchaos.installed(inj):
        assert pdh.chaos_aware_probe() is False
        sched.heal()
        assert pdh.chaos_aware_probe() is True
    assert inj.history("device.dispatch") == []   # probing fires nothing


def test_watchdog_off_runs_inline_and_keeps_the_fault_point(monkeypatch):
    """``FLINK_TPU_DEVICE_WATCHDOG=off``: no monitor, the thunk runs on the
    caller's thread, and an injected fault still fires — in both
    packages."""
    monkeypatch.setenv("FLINK_TPU_DEVICE_WATCHDOG", "off")
    for S in SIDES.values():
        assert S["dh"].get_monitor() is None
        inj = S["chaos"].FaultInjector(seed=3)
        inj.inject("device.dispatch", S["chaos"].FailTimes(1))
        with S["chaos"].installed(inj):
            with pytest.raises(S["chaos"].InjectedFault):
                S["dh"].guarded_dispatch(lambda: 1)
            assert S["dh"].guarded_dispatch(threading.get_ident) == \
                threading.get_ident()
        assert S["dh"].status_snapshot()["dispatches"] == 0


def test_operator_with_the_watchdog_off_fires_the_same(monkeypatch):
    """The port's operator with the watchdog off: no monitor is created,
    the dispatches still count, the fires are the guarded run's."""
    batches = _batches(n=8, values="random")
    _fast_monitor("port", heal_async=False)
    on = _drive("port", _op("port"), batches)
    monkeypatch.setenv("FLINK_TPU_DEVICE_WATCHDOG", "off")
    off = _drive("port", _op("port"), batches)
    assert off.monitor is None and on.monitor[0]["dispatches"] == 8
    assert off.hot == on.hot == 8
    _assert_fires_equal(off.fires, on.fires, "watchdog off")


# ---------------------------------------------------------------------------
# operator cycles, against JAX's and the clean run
# ---------------------------------------------------------------------------

def _cycle(side, batches, opkw, clean=False, **drive):
    _fast_monitor(side, heal_async=False)
    op = _op(side, **opkw)
    if clean:
        return _drive(side, op, batches)
    return _drive(side, op, batches, **drive)


def _replay(side, snap, batches, start, opkw, quarantined):
    """Restore ``snap`` into a fresh operator under a healthy or a still
    quarantined monitor and replay the batches from ``start``."""
    mon = _fast_monitor(side, heal_async=False)
    if quarantined:
        mon.quarantine("test: still wedged")
    op = _op(side, **opkw)
    with _jax_x64():
        op.restore_state(snapshot_to_jax(snap) if side == "jax" else snap)
    return _drive(side, op, batches, start=start)


DEVICE_CYCLE = dict(schedule=_wedge(8), snap_at=10, heal_at=11,
                    repromote_at=14)


@pytest.mark.parametrize("pipeline_depth", [0, 2])
@pytest.mark.parametrize("values", ["ones", "random"])
def test_quarantine_heal_cycle_device_tier(values, pipeline_depth):
    """The acceptance cycle on the device tier: wedge at dispatch 8 ->
    migrate (salvage the ring) -> checkpoint DURING the quarantine -> heal
    -> re-promote at the next safe point.  Fires, snapshot and counters
    equal JAX's bit for bit; fires equal the clean run's (bit for bit for
    exact sums, rtol 1e-6 for random f32: the quarantine folds in f64);
    the mid-quarantine snapshot restores on both tiers."""
    batches = _batches(values=values)
    opkw = dict(pipeline_depth=pipeline_depth)
    rtol = None if values == "ones" else 1e-6
    clean = _cycle("port", batches, opkw, clean=True)
    port = _cycle("port", batches, opkw, **DEVICE_CYCLE)
    jax_ = _cycle("jax", batches, opkw, **DEVICE_CYCLE)
    _assert_fires_equal(port.fires, jax_.fires, "port vs JAX")
    _assert_fires_equal(port.fires, clean.fires, "wedged vs clean", rtol,
                        same_dtype=False)
    assert port.health == {"degraded": 0, "quarantine_migrations": 1,
                           "repromotions": 1}
    assert port.monitor[0]["quarantines"] == 1
    assert port.monitor[0]["heals"] == 1
    assert port.snap_degraded is True
    assert port.parity() == jax_.parity()
    _assert_snap_equal(port.snap, jax_.snap)

    suffix = {w: f for w, f in clean.fires.items() if w >= 5 * WINDOW_MS}
    for quarantined in (False, True):
        p = _replay("port", port.snap, batches, 11, opkw, quarantined)
        j = _replay("jax", port.snap, batches, 11, opkw, quarantined)
        assert p.degraded is quarantined
        assert p.health["quarantine_migrations"] == int(quarantined)
        _assert_fires_equal(p.fires, j.fires, f"replay q={quarantined}")
        assert p.parity() == j.parity()
        got = {w: f for w, f in p.fires.items() if w >= 5 * WINDOW_MS}
        _assert_fires_equal(got, suffix, f"replay q={quarantined} vs clean",
                            rtol, same_dtype=False)


@pytest.mark.parametrize("pipeline_depth", [0, 2])
@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("values", ["quarters", "random"])
def test_quarantine_heal_cycle_host_tier(values, native, pipeline_depth):
    """The host tier: the mirror is already the authority, so degrading
    stops the replica dispatch; fires equal the clean run's bit for bit
    (random values too), and the re-promotion's refresh makes the replica
    equal the mirror again."""
    batches = _batches(seed=9, values=values)
    opkw = dict(emit_tier="host", native_emit=native,
                pipeline_depth=pipeline_depth)
    drive = dict(schedule=_wedge(6), snap_at=8, heal_at=10, repromote_at=12)
    clean = _cycle("port", batches, opkw, clean=True)
    _fast_monitor("port", heal_async=False)
    op = _op("port", **opkw)
    port = _drive("port", op, batches, **drive)
    jax_ = _cycle("jax", batches, opkw, **drive)
    _assert_fires_equal(port.fires, clean.fires, "wedged vs clean")
    _assert_fires_equal(port.fires, jax_.fires, "port vs JAX")
    assert port.health == {"degraded": 0, "quarantine_migrations": 1,
                           "repromotions": 1}
    assert port.snap_degraded is True
    assert port.parity() == jax_.parity()
    _assert_snap_equal(port.snap, jax_.snap)
    assert op.verify_mirror(), "re-promoted replica must equal the mirror"


def _paged_batches():
    out = []
    for i in range(6):
        # rotating key ranges: batch i touches keys [i*64, i*64+128)
        k = (np.arange(256) % 128) + (i * 64)
        v = np.random.default_rng(i).random(256).astype(np.float32)
        ts = i * (WINDOW_MS // 2) + np.sort(
            np.arange(256) % (WINDOW_MS // 2)).astype(np.int64)
        out.append((k.astype(np.int64), v, ts))
    return out


_OOM = ("fail", "RESOURCE_EXHAUSTED: out of memory allocating 1.0G")


@pytest.mark.parametrize("pipeline_depth", [0, 2])
def test_oom_forces_a_page_out_and_fires_survive(pipeline_depth):
    """An OOM at the third dispatch of a paged operator runs the pager's
    pressure valve (a forced page-out of the cold half, the batch's rows
    protected) and retries once: no quarantine, the fires are the clean
    paged run's, and the pager's counters are JAX's."""
    batches = _paged_batches()
    opkw = dict(paging_cap=512, pipeline_depth=pipeline_depth)
    oom = dict(schedule=lambda ch: ch.ActionSequence(["ok", "ok", _OOM]),
               seed=7)
    clean = _cycle("port", batches, opkw, clean=True)
    port = _cycle("port", batches, opkw, **oom)
    jax_ = _cycle("jax", batches, opkw, **oom)
    assert port.monitor[0]["oom_pageouts"] == 1
    assert port.monitor[0]["quarantines"] == 0
    assert port.paging["evictions"] > clean.paging["evictions"]
    _assert_fires_equal(port.fires, clean.fires, "OOM vs clean")
    _assert_fires_equal(port.fires, jax_.fires, "port vs JAX")
    assert port.parity() == jax_.parity()


def test_paged_quarantine_cycle_matches_jax():
    """A wedge on the paged device tier: the salvage merges the ring and
    the spill tier into the mirror, re-promotion pages the overflow back
    out; fires and the mid-quarantine snapshot equal JAX's."""
    batches = _paged_batches() + [
        (k + 512, v, ts + 3 * WINDOW_MS) for k, v, ts in _paged_batches()]
    opkw = dict(paging_cap=128)
    drive = dict(schedule=_wedge(5), snap_at=6, heal_at=7, repromote_at=8)
    clean = _cycle("port", batches, opkw, clean=True)
    port = _cycle("port", batches, opkw, **drive)
    jax_ = _cycle("jax", batches, opkw, **drive)
    assert port.health["repromotions"] == 1
    _assert_fires_equal(port.fires, jax_.fires, "port vs JAX")
    _assert_fires_equal(port.fires, clean.fires, "wedged vs clean", 1e-6,
                        same_dtype=False)
    assert port.parity() == jax_.parity()
    _assert_snap_equal(port.snap, jax_.snap)


def _key_growth_scenario(side):
    S = SIDES[side]
    mon = _fast_monitor(side, heal_async=False)
    op = _op(side, initial_key_capacity=16)
    inj = S["chaos"].FaultInjector(seed=12)
    sched = inj.inject("device.dispatch", S["chaos"].WedgedDevice(at=2))
    out = []

    def batch(k, ts):
        return S["RB"]({"k": k, "v": np.ones(k.size, np.float32)},
                       timestamps=ts)
    with _jax_x64(), S["chaos"].installed(inj):
        k = np.arange(16, dtype=np.int64)
        ts = np.zeros(16, np.int64)
        out += op.process_batch(batch(k, ts))
        out += op.process_batch(batch(k, ts))        # wedges -> degrade
        assert op._degraded
        # 200 NEW keys touch only window 1's pane while degraded
        out += op.process_batch(batch(np.arange(16, 216, dtype=np.int64),
                                      np.full(200, 1500, np.int64)))
        out += op.process_watermark(S["WM"](2100))
        op.prepare_snapshot_pre_barrier()
        snap = op.snapshot_state()
        assert np.asarray(snap["counts"]).shape[0] == 216
        sched.heal()
        assert mon.probe_now()
        op.prepare_snapshot_pre_barrier()
        assert not op._degraded
        out += op.end_input()
    if side == "jax":
        snap = snapshot_from_jax(snap)
    return _by_window(out), snap, op.device_health_stats()


def test_degraded_key_growth_keeps_all_panes_consistent():
    fires, snap, health = _key_growth_scenario("port")
    assert [(w, len(k), float(r.sum())) for w, (k, r) in
            sorted(fires.items())] == [(0, 16, 32.0), (1000, 200, 200.0)]
    jfires, jsnap, jhealth = _key_growth_scenario("jax")
    _assert_fires_equal(fires, jfires, "port vs JAX")
    _assert_snap_equal(snap, jsnap)
    assert health == jhealth


def _probe_batches(values):
    rng = np.random.default_rng(7)
    out = []
    for i in range(20):
        k = rng.integers(0, 64, 512).astype(np.int64)
        v = (np.ones(512, np.float32) if values == "ones"
             else rng.random(512).astype(np.float32))
        ts = i * 50 + np.sort(rng.integers(0, 50, 512)).astype(np.int64)
        out.append((k, v, ts))
    return out


PROBE_CYCLE = dict(snap_at=12, heal_at=12, repromote_at=16, seed=3)


def _probe_cycle(side, batches, opkw, at):
    # a wedge on a dispatch of a new geometry waits out the grace
    _fast_monitor(side, heal_async=False, deadline_floor_s=0.5,
                  first_dispatch_grace_s=5.0)
    op = _op(side, emit_tier="host", window_ms=100, **opkw)
    return _drive(side, op, batches, schedule=_wedge(at), **PROBE_CYCLE)


@pytest.mark.parametrize("pipeline_depth", [0, 2])
@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("values", ["ones", "random"])
def test_mid_batch_probe_lane_wedge(values, native, pipeline_depth):
    """The probe lane wedges inside its guarded dispatch at dispatch 8: the
    delta ring is salvaged into the mirror, the batch refolds through the
    host pass, the tier degrades; heal and re-promotion follow.  Equal to
    JAX's wedged run bit for bit, and to the clean probe-off run (bit for
    bit with ones; the probe lane's delta sums in another order, so random
    values are held to 1e-6)."""
    batches = _probe_batches(values)
    opkw = dict(device_probe="on", native_emit=native,
                pipeline_depth=pipeline_depth)
    _fast_monitor("port", heal_async=False)
    clean = _drive("port", _op("port", emit_tier="host", window_ms=100,
                               native_emit=native), batches)
    port = _probe_cycle("port", batches, opkw, 8)
    jax_ = _probe_cycle("jax", batches, opkw, 8)
    _assert_fires_equal(port.fires, jax_.fires, "port vs JAX")
    _assert_fires_equal(port.fires, clean.fires, "wedged vs clean",
                        None if values == "ones" else 1e-6)
    assert port.health == {"degraded": 0, "quarantine_migrations": 1,
                           "repromotions": 1}
    assert port.snap_degraded is True
    assert port.parity() == jax_.parity()
    _assert_snap_equal(port.snap, jax_.snap)


@pytest.mark.parametrize("pipeline_depth", [0, 2])
@pytest.mark.parametrize("device_sync", ["deferred", "scatter"])
def test_mid_scan_wedge(device_sync, pipeline_depth):
    """The fused lane's one-step pass wedges (its second pass: dispatch 4
    under deferred sync, 5 under scatter sync, where the first batch's
    miss catch-up is a dispatch too): no staged row reached a state plane,
    the prior delta is salvaged, every staged batch refolds on the host.
    Equal to JAX's and to the clean unfused run."""
    batches = _probe_batches("ones")
    opkw = dict(device_probe="on", superbatch=4, device_sync=device_sync,
                pipeline_depth=pipeline_depth)
    _fast_monitor("port", heal_async=False)
    clean = _drive("port", _op("port", emit_tier="host", window_ms=100),
                   batches)
    at = 4 if device_sync == "deferred" else 5
    port = _probe_cycle("port", batches, opkw, at)
    jax_ = _probe_cycle("jax", batches, opkw, at)
    assert port.history[at - 1] == "hang"
    assert port.monitor[2]["window-agg.fused_scan"] >= 2
    _assert_fires_equal(port.fires, clean.fires, "wedged scan vs clean")
    _assert_fires_equal(port.fires, jax_.fires, "port vs JAX")
    assert port.health == {"degraded": 0, "quarantine_migrations": 1,
                           "repromotions": 1}
    assert port.parity() == jax_.parity()


# ---------------------------------------------------------------------------
# the port alone: in-place state, refusals, false heals
# ---------------------------------------------------------------------------

def test_in_place_flag_makes_the_salvage_raise():
    """An attempt that stopped after its first in-place write leaves
    ``_writing`` set (JAX's donated-and-deleted buffers): the migration
    refuses to salvage and re-raises the quarantine from that cause — the
    restart path, not a silently wrong mirror."""
    mon = _fast_monitor("port", heal_async=False)
    op = _op("port")
    inj = pchaos.FaultInjector(seed=1)
    sched = inj.inject("device.dispatch", pchaos.WedgedDevice(at=2))
    k = np.arange(8, dtype=np.int64)
    with pchaos.installed(inj):
        op.process_batch(RecordBatch({"k": k, "v": np.ones(8, np.float32)},
                                     timestamps=np.zeros(8, np.int64)))
        op._writing = True     # an abandoned attempt died mid-write
        with pytest.raises(pdh.DeviceQuarantinedError) as ei:
            op.process_batch(RecordBatch(
                {"k": k, "v": np.ones(8, np.float32)},
                timestamps=np.zeros(8, np.int64)))
    sched.heal()               # release the sacrificed lane
    assert isinstance(ei.value.__cause__, RuntimeError)
    assert "in-place write" in str(ei.value.__cause__)
    assert mon.quarantined and not op._degraded


def test_in_place_flag_on_the_probe_lane_makes_the_delta_salvage_raise():
    _fast_monitor("port", heal_async=False)
    op = _op("port", emit_tier="host", window_ms=100, device_probe="on")
    inj = pchaos.FaultInjector(seed=1)
    # batch 0: probe step + miss catch-up; batches 1, 2: the probe step
    # alone; batch 3's probe step (dispatch 5) wedges
    sched = inj.inject("device.dispatch", pchaos.WedgedDevice(at=5))
    batches = _probe_batches("ones")
    with pchaos.installed(inj):
        for k, v, ts in batches[:3]:
            op.process_batch(RecordBatch({"k": k, "v": v}, timestamps=ts))
        assert op._delta_panes and inj.fired("device.dispatch") == 4
        op._writing = True
        k, v, ts = batches[3]
        with pytest.raises(pdh.DeviceQuarantinedError) as ei:
            op.process_batch(RecordBatch({"k": k, "v": v}, timestamps=ts))
    sched.heal()
    assert "in-place write" in str(ei.value.__cause__)


class _Gate:
    """A stand-in for the previous dispatch's CUDA event whose card does not
    answer: ``synchronize`` blocks until the gate opens."""

    def __init__(self):
        self.open = threading.Event()

    def synchronize(self):
        self.open.wait(timeout=30)


def test_an_abandoned_dispatch_never_writes_into_the_migration():
    """A dispatch abandoned in its fence wait wakes when the card answers
    again, as the migration's own download does: it must not fold its batch
    into the ring that download reads (the migration folds that batch into
    the mirror itself).  The gate opens at the start of the download, which
    then gives the abandoned dispatch time to write: the fires still equal
    the clean run's."""
    batches = _batches(n=12, values="quarters")
    _fast_monitor("port", heal_async=False)
    clean = _drive("port", _op("port"), batches)
    mon = _fast_monitor("port", heal_async=False, probe_fn=lambda: True)
    op = _op("port")
    gate = _Gate()
    columns = op._device_columns

    def download(*args):
        gate.open.set()
        time.sleep(0.3)            # the abandoned dispatch wakes meanwhile
        return columns(*args)
    op._device_columns = download
    out = []
    for i, (k, v, ts) in enumerate(batches):
        if i == 3:
            op._fence = gate       # batch 3's dispatch waits on a dead card
        out += op.process_batch(RecordBatch({"k": k, "v": v}, timestamps=ts))
        out += op.process_watermark(Watermark(int(ts.max()) - 1))
        if i == 6:
            assert mon.probe_now()
            out += op.prepare_snapshot_pre_barrier()
    out += op.end_input()
    assert mon.counters["watchdog_timeouts"] == 1 and gate.open.is_set()
    assert op.device_health_stats() == {
        "degraded": 0, "quarantine_migrations": 1, "repromotions": 1}
    _assert_fires_equal(_by_window(out), clean.fires, "abandoned dispatch",
                        same_dtype=False)


def test_a_failure_after_the_first_write_is_never_retried(monkeypatch):
    """A transient error raised inside the write leaves the flag set; the
    monitor's retry then refuses (FATAL) instead of folding the rows a
    second time."""
    _fast_monitor("port", heal_async=False)
    op = _op("port")
    calls = []

    def failing(*args):
        calls.append(1)
        raise RuntimeError("UNAVAILABLE: socket closed")
    monkeypatch.setattr(pwa, "ordered_fold_counts", failing)
    k = np.arange(8, dtype=np.int64)
    with pytest.raises(RuntimeError, match="first in-place write"):
        op.process_batch(RecordBatch({"k": k, "v": np.ones(8, np.float32)},
                                     timestamps=np.zeros(8, np.int64)))
    assert calls == [1] and op._writing
    assert pdh.get_monitor().counters["transient_retries"] == 1


class _DeviceOnlySum(SumAggregator):
    """A sum without numpy twins: no host tier to migrate to."""

    def supports_host_emit(self):
        return False


def test_an_aggregate_without_a_host_twin_reraises():
    mon = _fast_monitor("port", heal_async=False, first_dispatch_grace_s=0.3)
    op = _op("port", agg=_DeviceOnlySum())
    inj = pchaos.FaultInjector(seed=8)
    sched = inj.inject("device.dispatch", pchaos.WedgedDevice(at=1))
    with pchaos.installed(inj):
        with pytest.raises(pdh.DeviceQuarantinedError):
            op.process_batch(RecordBatch(
                {"k": np.arange(8, dtype=np.int64) % 3,
                 "v": np.ones(8, np.float32)},
                timestamps=np.arange(8, dtype=np.int64)))
    sched.heal()
    assert mon.quarantined
    assert op.device_health_stats()["quarantine_migrations"] == 0


@pytest.mark.parametrize("emit_tier", ["device", "host"])
def test_a_false_heal_rolls_back_and_retries_later(emit_tier):
    """The probe reads healthy while the card still hangs: the guarded
    re-promotion trips its deadline, the operator stays degraded on its
    host tier (nothing lost), and a real heal re-promotes later."""
    batches = _batches(n=12, values="quarters")
    _fast_monitor("port", heal_async=False)
    clean = _drive("port", _op("port", emit_tier=emit_tier), batches)
    mon = _fast_monitor("port", heal_async=False, first_dispatch_grace_s=0.5,
                        probe_fn=lambda: True)
    op = _op("port", emit_tier=emit_tier)
    inj = pchaos.FaultInjector(seed=1)
    sched = inj.inject("device.dispatch", pchaos.WedgedDevice(at=4))
    out = []
    with pchaos.installed(inj):
        for i, (k, v, ts) in enumerate(batches):
            out += op.process_batch(RecordBatch({"k": k, "v": v},
                                                timestamps=ts))
            out += op.process_watermark(Watermark(int(ts.max()) - 1))
            if i == 5:
                assert mon.probe_now()            # a false heal
                out += op.prepare_snapshot_pre_barrier()
                assert op._degraded and mon.quarantined
            if i == 8:
                sched.heal()
                assert mon.probe_now()
                out += op.prepare_snapshot_pre_barrier()
                assert not op._degraded
        out += op.end_input()
    assert op.device_health_stats() == {
        "degraded": 0, "quarantine_migrations": 1, "repromotions": 1}
    assert mon.counters["quarantines"] == 2 and mon.counters["heals"] == 2
    _assert_fires_equal(_by_window(out), clean.fires, "false heal vs clean",
                        same_dtype=emit_tier == "host")


def test_hot_dispatches_count_guarded_dispatches_like_jax():
    """``fused_stats()["hot_dispatches"]`` counts JAX's sites on each lane:
    the replica fold, the probe step and its miss catch-up, the fused
    pass."""
    for opkw, window_ms in ((dict(), WINDOW_MS),
                            (dict(emit_tier="host", device_probe="on"), 100),
                            (dict(emit_tier="host", device_probe="on",
                                  superbatch=4, device_sync="deferred"), 100),
                            (dict(emit_tier="host", device_sync="deferred"),
                             100)):
        got = {}
        for side in SIDES:
            run = _cycle(side, _probe_batches("ones"),
                         dict(opkw, window_ms=window_ms), clean=True)
            got[side] = (run.hot, run.monitor)
        assert got["port"] == got["jax"], opkw

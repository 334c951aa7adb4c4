"""Port parity for the ``auto`` calibrations: ``flink_tpu_torch``'s transport
verdict, shard counts, super-batch depth and device-probe verdict against
``flink_tpu``'s, and all-default operators of both packages on one stream.

Every verdict of both packages is process-wide.  The ``verdicts`` fixture
pins each of them (None = not measured yet) and puts every one back after
the test, in both packages, so no verdict pinned or measured here leaks
into a later test of the same worker.  The JAX package's own device-probe
measurement imports ``jax.experimental.enable_x64``, which jax 0.9 lacks:
its verdict is always pinned here, never measured.
"""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.experimental
import jax.numpy as jnp

from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.core.batch import Watermark as JaxWatermark
from flink_tpu.core.functions import RuntimeContext as JaxContext
from flink_tpu.core.functions import SumAggregator as JaxSum
from flink_tpu.operators import fused_step as jfs
from flink_tpu.operators.window_agg import WindowAggOperator as JaxOp
from flink_tpu.state import device_keyindex as jdk
from flink_tpu.state import native_mirror as jnm
from flink_tpu.utils import transport as jtransport
from flink_tpu.windowing.assigners import TumblingEventTimeWindows as JaxTumbling
from flink_tpu_torch.core.batch import RecordBatch, Watermark
from flink_tpu_torch.core.functions import RuntimeContext, SumAggregator
from flink_tpu_torch.interop import snapshot_from_jax
from flink_tpu_torch.operators import fused_step as pfs
from flink_tpu_torch.operators.window_agg import WindowAggOperator
from flink_tpu_torch.ops import scatter as sc
from flink_tpu_torch.state import device_keyindex as pdk
from flink_tpu_torch.state import native_mirror as pnm
from flink_tpu_torch.utils import transport as ptransport
from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

ENVS = ("FLINK_TPU_NATIVE_SHARDS", "FLINK_TPU_SUPERBATCH",
        "FLINK_TPU_DEVICE_PROBE")


@contextlib.contextmanager
def _jax_x64():
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64",
                       lambda new_val=True: jax.enable_x64(new_val),
                       raising=False)
        yield


@pytest.fixture
def verdicts(monkeypatch):
    """Pins the process-wide verdicts of both packages the same way and
    restores every one of them after the test.  Returns ``pin(taxed,
    shards, super_shards, depth, probe)``; None leaves a verdict to be
    measured.  The calibration environment variables are unset."""
    for env in ENVS:
        monkeypatch.delenv(env, raising=False)

    def pin(taxed=None, shards=None, super_shards=None, depth=None,
            probe=None):
        for tr in (jtransport, ptransport):
            monkeypatch.setattr(tr, "_samples", [])
            monkeypatch.setattr(tr, "_verdict", taxed)
        for nm in (jnm, pnm):
            monkeypatch.setattr(nm, "_calibrated_shards", shards)
        for fs in (jfs, pfs):
            monkeypatch.setattr(fs, "_calibrated_depth", depth)
            monkeypatch.setattr(fs, "_calibrated_shards", super_shards)
        for dk in (jdk, pdk):
            monkeypatch.setattr(dk, "_calibrated_probe", probe)
        monkeypatch.setattr(pnm, "last_shard_s", {})
        monkeypatch.setattr(pfs, "last_measurement", {})
        monkeypatch.setattr(pdk, "last_measurement", {})

    pin()
    return pin


# ---------------------------------------------------------------------------
# transport: the same samples give the same verdict
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("samples", [
    [(1.0, 5.0), (1.0, 0.001), (1.0, 0.002)],          # min wins: healthy
    [(2.0, 0.08)] * 3,                                 # 40 ms/MB: taxed
    [(0.001, 0.001)] * 10,                             # tiny: never a verdict
    [(0.4, 1.0), (0.6, 0.0012), (0.5, 0.004), (2.0, 0.02), (1.0, 0.001)],
    [(0.49, 0.0001), (0.5, 0.003), (3.0, 0.02), (0.7, 0.0049)],
], ids=["min-sample", "taxed", "tiny", "mixed", "edge"])
def test_transport_verdicts_match_jax(verdicts, samples):
    for mb, seconds in samples:
        for tr in (jtransport, ptransport):
            tr.record_dispatch_cost(mb, seconds)
        assert ptransport.dispatch_taxed() is jtransport.dispatch_taxed()
        assert ptransport.dispatch_ms_per_mb() == \
            jtransport.dispatch_ms_per_mb()
    assert ptransport.DISPATCH_TAXED_ABOVE_MS_PER_MB == \
        jtransport.DISPATCH_TAXED_ABOVE_MS_PER_MB
    assert ptransport.MIN_SAMPLES == jtransport.MIN_SAMPLES
    assert ptransport.MIN_SAMPLE_MB == jtransport.MIN_SAMPLE_MB
    for tr in (jtransport, ptransport):
        tr.reset(verdict=True)
        assert tr.dispatch_taxed() is True and tr.dispatch_ms_per_mb() is None


# ---------------------------------------------------------------------------
# shard counts and super-batch depth from the same timings
# ---------------------------------------------------------------------------

def _fake_measure(table, calls=None):
    """A ``measure_fused_probe`` stand-in: seconds from ``table`` keyed by
    (shards, "super" for super-batch-sized blocks else "batch")."""
    def measure(lib, shards, n_keys, B, keys_all, vals_all, rounds=3):
        if calls is not None:
            calls.append((shards, B))
        return table[(shards, "super" if B > 1 << 17 else "batch")]
    return measure


TIMINGS = {
    "shards-win": {(1, "batch"): 2.0, (4, "batch"): 1.0,
                   (1, "super"): 3.0, (4, "super"): 1.0},
    "serial-wins": {(1, "batch"): 1.0, (4, "batch"): 2.0,
                    (1, "super"): 100.0, (4, "super"): 200.0},
    "super-shards-only": {(1, "batch"): 1.0, (4, "batch"): 1.5,
                          (1, "super"): 5.0, (4, "super"): 2.0},
}
EXPECT = {"shards-win": (4, 4, 8), "serial-wins": (1, 1, 1),
          "super-shards-only": (1, 4, 8)}


@pytest.mark.parametrize("case", list(TIMINGS))
def test_shard_and_superbatch_verdicts_match_jax(verdicts, monkeypatch,
                                                 case):
    """The same timings in both packages' ``measure_fused_probe`` give the
    same ``calibrated_shards``, ``calibrated_super_shards`` and
    ``calibrated_superbatch`` (the concatenation in the super side is timed
    for real, small beside these timings)."""
    calls = {"jax": [], "port": []}
    for nm, side in ((jnm, "jax"), (pnm, "port")):
        monkeypatch.setattr(nm, "auto_shards", lambda: 4)
        monkeypatch.setattr(nm, "measure_fused_probe",
                            _fake_measure(TIMINGS[case], calls[side]))
    got = (pnm.calibrated_shards(), pfs.calibrated_super_shards(),
           pfs.calibrated_superbatch())
    want = (jnm.calibrated_shards(), jfs.calibrated_super_shards(),
            jfs.calibrated_superbatch())
    assert got == want == EXPECT[case]
    assert calls["port"] == calls["jax"]
    assert pfs.last_measurement["t_per"] == TIMINGS[case][
        (EXPECT[case][0], "batch")] * pfs.AUTO_DEPTH
    assert pnm.last_shard_s == {1: TIMINGS[case][(1, "batch")],
                                4: TIMINGS[case][(4, "batch")]}
    # cached: a second ask measures nothing
    n = len(calls["port"])
    assert pfs.calibrated_superbatch() == EXPECT[case][2]
    assert pnm.calibrated_shards() == EXPECT[case][0]
    assert len(calls["port"]) == n
    pfs._reset_calibration_for_tests()
    assert pfs._calibrated_depth is None and pfs._calibrated_shards is None
    assert pfs.last_measurement == {}


@pytest.mark.parametrize("env, value, call, want", [
    ("FLINK_TPU_NATIVE_SHARDS", "3", "shards", 3),
    ("FLINK_TPU_SUPERBATCH", "5", "superbatch", 5),
    ("FLINK_TPU_SUPERBATCH", "1", "superbatch", 1),
    ("FLINK_TPU_DEVICE_PROBE", "off", "probe", False),
    ("FLINK_TPU_DEVICE_PROBE", "on", "probe", True),
])
def test_env_overrides_win_in_both_packages(verdicts, monkeypatch, env,
                                            value, call, want):
    """The environment pins each verdict under the same name in both
    packages, and nothing is measured."""
    def never(*a, **kw):
        raise AssertionError("measured despite the environment's pin")

    for nm in (jnm, pnm):
        monkeypatch.setattr(nm, "measure_fused_probe", never)
    monkeypatch.setattr(pdk, "_measure_device_probe", never)
    monkeypatch.setattr(jdk, "_measure_device_probe", never)
    monkeypatch.setenv(env, value)
    fns = {"shards": (pnm.calibrated_shards, jnm.calibrated_shards),
           "superbatch": (pfs.calibrated_superbatch,
                          jfs.calibrated_superbatch),
           "probe": (lambda: pdk.calibrated_device_probe("cpu"),
                     jdk.calibrated_device_probe)}[call]
    assert fns[0]() == fns[1]() == want


def test_device_probe_measurement_runs_the_plain_versions_on_the_cpu(
        verdicts, monkeypatch):
    """The port's device side on the CPU: the plain probe and fold, no
    kernel launch counted, a bool verdict, and both sides' seconds."""
    monkeypatch.setattr(pnm, "_calibrated_shards", 1)
    launches = (pdk.probe.launches, sc.ordered_fold_counts.launches)
    verdict = pdk._measure_device_probe(torch.device("cpu"))
    assert isinstance(verdict, bool)
    assert (pdk.probe.launches, sc.ordered_fold_counts.launches) == launches
    m = pdk.last_measurement
    assert m["host_s"] > 0 and m["device_s"] > 0
    assert verdict == (m["device_s"] < m["host_s"])
    # the public verdict measures once and caches it
    calls = []
    monkeypatch.setattr(pdk, "_measure_device_probe",
                        lambda device: calls.append(device) or verdict)
    assert pdk.calibrated_device_probe("cpu") is verdict
    assert pdk.calibrated_device_probe("cpu") is verdict
    assert calls == [torch.device("cpu")]


def test_shard_calibration_runs_once_across_threads(verdicts, monkeypatch):
    """Eight threads ask at once: one A/B (two timed passes), one verdict
    for all of them."""
    import sys
    calls = []
    lock = threading.Lock()

    def slow(lib, shards, n_keys, B, keys_all, vals_all, rounds=3):
        with lock:
            calls.append(shards)
        time.sleep(0.02)
        return {1: 0.5, 4: 0.25}[shards]

    monkeypatch.setattr(pnm, "auto_shards", lambda: 4)
    monkeypatch.setattr(pnm, "measure_fused_probe", slow)
    start = threading.Barrier(8)
    got = [None] * 8

    def ask(i):
        start.wait(timeout=10)
        got[i] = pnm.calibrated_shards()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert got == [4] * 8
    assert sorted(calls) == [1, 4]


# ---------------------------------------------------------------------------
# all-default operators of both packages, verdicts pinned alike
# ---------------------------------------------------------------------------

def _batches(n_batches=10, nk=1500, b=4000, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        keys = rng.integers(0, nk, b).astype(np.int64)
        vals = rng.random(b).astype(np.float32)
        ts = i * 50 + np.sort(rng.integers(0, 50, b)).astype(np.int64)
        if i == 8:      # straddles a fired window: late drops and re-fires
            ts[: b // 4] = 120
        out.append((keys, vals, ts))
    return out


def _drive(op, batches, RB, WM, snap_at=6):
    out, snap = [], None
    for i, (keys, vals, ts) in enumerate(batches):
        out += op.process_batch(RB({"k": keys, "v": vals}, timestamps=ts))
        out += op.process_watermark(WM(int(ts.max()) - 1))
        if i == snap_at:
            out += op.prepare_snapshot_pre_barrier()
            snap = op.snapshot_state()
    out += op.end_input()
    return out, snap


def _digests(out):
    return [(int(np.asarray(b.column("window_start"))[0]), len(b),
             np.asarray(b.column("k")).tobytes(),
             np.asarray(b.column("result")).tobytes()) for b in out]


def _lane(op, side):
    s, f = op.device_probe_stats(), op.fused_stats()
    native = op._nm is not None if side == "jax" else op.native_mirror_active
    return {"emit_tier": op.emit_tier,
            "snapshot_source": op.snapshot_source,
            "device_sync_mode": op.device_sync_mode,
            "probe": s["enabled"], "depth": f["depth"],
            "native": native, "nm_shards": op._nm_shards if native else None,
            "calib_batches": op._calib_batches}


def _counters(op):
    s, f = op.device_probe_stats(), op.fused_stats()
    return {"late_dropped": op.late_dropped,
            "num_keys": op.key_index.num_keys, "watermark": op.watermark,
            "last_fired_window": op.last_fired_window,
            "probe_hits": s["probe_hits"], "probe_misses": s["probe_misses"],
            "miss_inserts": s["miss_inserts"],
            **{k: f[k] for k in ("staged_batches", "flushes",
                                 "scan_dispatches", "scan_steps",
                                 "host_super_passes")}}


def _assert_snaps_equal(got, want):
    for k in ("pane_base", "max_pane", "last_fired_window", "watermark",
              "late_dropped", "P"):
        assert got[k] == want[k], k
    for k in ("panes", "counts"):
        assert np.array_equal(got[k], want[k]), k
    assert np.array_equal(got["key_index"]["reverse"],
                          want["key_index"]["reverse"])
    for g, w in zip(got["leaves"], want["leaves"], strict=True):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


#: (operator keyword arguments beyond the defaults, pinned verdicts, what
#: the lane must resolve to)
DEFAULT_CASES = {
    "all-default": ({}, dict(taxed=None, probe=None),
                    dict(emit_tier="device", device_sync_mode="scatter",
                         probe=0, depth=1, native=False)),
    "host-scatter": (dict(emit_tier="host"),
                     dict(taxed=False, shards=2, probe=True),
                     dict(emit_tier="host", snapshot_source="mirror",
                          device_sync_mode="scatter", probe=1, depth=1,
                          native=True, nm_shards=2)),
    "host-deferred": (dict(emit_tier="host"),
                      dict(taxed=True, shards=2, probe=True),
                      dict(device_sync_mode="deferred", probe=1, depth=1,
                           native=True)),
    "host-probe-off": (dict(emit_tier="host"),
                       dict(taxed=False, shards=1, probe=False),
                       dict(device_sync_mode="scatter", probe=0, depth=1)),
    "host-superbatch-auto": (dict(emit_tier="host", superbatch=0),
                             dict(taxed=True, shards=2, probe=True, depth=4),
                             dict(device_sync_mode="deferred", probe=1,
                                  depth=4)),
    "host-superbatch-auto-probe-off": (
        dict(emit_tier="host", superbatch=0),
        dict(taxed=False, shards=2, super_shards=3, probe=False, depth=4),
        dict(device_sync_mode="scatter", probe=0, depth=4, nm_shards=2)),
    "host-calibrates-then-settles": (
        dict(emit_tier="host"), dict(taxed=None, shards=2, probe=True),
        dict(device_sync_mode="scatter", probe=1, calib_batches=8)),
}


@pytest.mark.parametrize("case", list(DEFAULT_CASES))
def test_default_operators_resolve_and_fire_like_jax(verdicts, case):
    """``WindowAggOperator`` with JAX's defaults in both packages (the port
    on ``device="cpu"``, where ``auto`` picks the device tier as JAX's CPU
    backend does; ``emit_tier="host"`` asked for where a case needs it):
    the same resolved lane, fires and snapshot bit for bit, the same
    counters.  Batches of 4000 rows (~32 kB) never give a sync sample, so
    "host-calibrates-then-settles" runs 8 calibrating batches (probe off)
    and then settles on scatter with the probe on."""
    kw, pins, want = DEFAULT_CASES[case]
    verdicts(**pins)
    batches = _batches()
    with _jax_x64():
        jop = _op("jax", **kw)
        jout, jsnap = _drive(jop, batches, JaxBatch, JaxWatermark)
    pop = _op("port", **kw)
    pout, psnap = _drive(pop, batches, RecordBatch, Watermark)
    jl, pl = _lane(jop, "jax"), _lane(pop, "port")
    assert pl == jl
    assert {k: pl[k] for k in want} == want
    assert _digests(pout) == _digests(jout) and len(pout) > 0
    _assert_snaps_equal(psnap, snapshot_from_jax(jsnap))
    assert _counters(pop) == _counters(jop)
    if case == "host-superbatch-auto-probe-off":
        assert pop._fused_shards == jop._fused_shards == 3
        assert pop.fused_stats()["host_super_passes"] > 0
    if pins["taxed"] is None:
        assert ptransport.dispatch_taxed() is None
        assert jtransport.dispatch_taxed() is None
    pop.close()
    jop.close()


def _op(side, **kw):
    """An operator of either package with JAX's defaults plus ``kw`` (the
    port's on the CPU)."""
    if side == "jax":
        op = JaxOp(JaxTumbling.of(100), JaxSum(jnp.float32), key_column="k",
                   value_column="v", **kw)
        op.open(JaxContext())
        return op
    op = WindowAggOperator(TumblingEventTimeWindows.of(100), SumAggregator(),
                           key_column="k", value_column="v", device="cpu",
                           **kw)
    op.open(RuntimeContext())
    return op


def test_small_batches_settle_on_scatter_in_both_packages(verdicts):
    """``test_auto_on_cpu_backend_small_batches_settle_scatter``'s case on
    the host tier: sub-0.5 MB batches never give a sample; after 8
    calibrating batches both packages settle on scatter, and the verdict
    stays unmeasured."""
    verdicts(shards=1, probe=False)
    batches = _batches(nk=200, b=300)
    with _jax_x64():
        jop = _op("jax", emit_tier="host")
        modes = []
        for keys, vals, ts in batches:
            jop.process_batch(JaxBatch({"k": keys, "v": vals},
                                       timestamps=ts))
            modes.append(jop.device_sync_mode)
    pop = _op("port", emit_tier="host")
    pmodes = []
    for keys, vals, ts in batches:
        pop.process_batch(RecordBatch({"k": keys, "v": vals}, timestamps=ts))
        pmodes.append(pop.device_sync_mode)
    assert pmodes == modes == [None] * 8 + ["scatter"] * 2
    assert ptransport.dispatch_taxed() is None
    assert jtransport.dispatch_taxed() is None
    assert pop.verify_mirror()


def test_calibrating_batches_feed_the_transport(verdicts):
    """Batches past ``MIN_SAMPLE_MB`` give samples: three calibrating
    batches reach a verdict, and the operator resolves from it (on the CPU
    the fold's own cost is the transport, as in JAX)."""
    verdicts(shards=1, probe=False)
    op = _op("port", emit_tier="host")
    rng = np.random.default_rng(3)
    B = 1 << 16        # 0.5 MB of int32 ids and f32 values a batch
    for i in range(4):
        keys = rng.integers(0, 5000, B).astype(np.int64)
        op.process_batch(RecordBatch(
            {"k": keys, "v": rng.random(B).astype(np.float32)},
            timestamps=np.full(B, 10 + i, np.int64)))
    assert ptransport.dispatch_taxed() is not None
    assert op._calib_batches == 3
    assert op.device_sync_mode == (
        "deferred" if ptransport.dispatch_taxed() else "scatter")
    assert ptransport.dispatch_ms_per_mb() > 0
    uploads = 4 if op.device_sync_mode == "scatter" else 3
    assert op.phase_bytes["h2d"] == uploads * B * 8

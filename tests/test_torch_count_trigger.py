"""Port parity for count triggers and the generic window fold:
``flink_tpu_torch``'s ``WindowAggOperator`` (and ``MeshWindowAggOperator``)
with ``CountTrigger``/``PurgingTrigger``/``GlobalWindows`` and with
``LambdaReduce`` against ``flink_tpu``'s on the CPU.

The cases are those of ``tests/test_window_agg.py`` (count windows, count
triggers over tumbling and sliding windows, purging and not, value
baselines, the non-invertible rejection, the generic reduce), run through
both packages on one seeded stream: keys grow past the initial capacity,
panes outgrow the ring and expire, watermarks come every third batch.
Count fires read the same counts and run the same full-capacity pane
combine; the generic fold runs the same segmented scan (see
``tests/test_torch_generic_fold.py``).  So fires (keys, values, window
bounds and timestamps, in order, at the same calls), snapshots with their
count and value baselines, restores across packages both ways, and rescale
splits and merges are compared BIT FOR BIT.

Every calibration verdict is pinned and restored (``verdicts`` of
``test_torch_calibration.py``), and both packages' monitors and fault
injectors are put back after each test.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from flink_tpu.core import functions as jfn
from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.core.batch import Watermark as JaxWatermark
from flink_tpu.operators.window_agg import WindowAggOperator as JaxOp
from flink_tpu.parallel import mesh as jmesh
from flink_tpu.parallel.mesh_runtime import MeshWindowAggOperator as JaxMesh
from flink_tpu.runtime import device_health as jdh
from flink_tpu.state.paging import PagingConfig as JaxPaging
from flink_tpu.testing import chaos as jchaos
from flink_tpu.windowing import assigners as jwin
from flink_tpu.windowing import triggers as jtrig
from flink_tpu_torch.core import functions as pfn
from flink_tpu_torch.core.batch import RecordBatch, Watermark
from flink_tpu_torch.interop import snapshot_from_jax, snapshot_to_jax
from flink_tpu_torch.operators.window_agg import _LATER, WindowAggOperator
from flink_tpu_torch.parallel import mesh as pmesh
from flink_tpu_torch.parallel.mesh_runtime import MeshWindowAggOperator
from flink_tpu_torch.runtime import device_health as pdh
from flink_tpu_torch.state.paging import PagingConfig
from flink_tpu_torch.state.shard_layout import densify_keyed_snapshot
from flink_tpu_torch.testing import chaos as pchaos
from flink_tpu_torch.windowing import assigners as pwin
from flink_tpu_torch.windowing import triggers as ptrig
from test_torch_calibration import verdicts  # noqa: F401

SIDES = {
    "jax": dict(fn=jfn, win=jwin, trig=jtrig, Op=JaxOp, Mesh=JaxMesh,
                mesh=jmesh.make_mesh, RB=JaxBatch, WM=JaxWatermark,
                dh=jdh, chaos=jchaos, Paging=JaxPaging, kw={},
                f32=jnp.float32),
    "port": dict(fn=pfn, win=pwin, trig=ptrig, Op=WindowAggOperator,
                 Mesh=MeshWindowAggOperator,
                 mesh=lambda D: pmesh.make_mesh(devices=["cpu"] * D),
                 RB=RecordBatch, WM=Watermark, dh=pdh, chaos=pchaos,
                 Paging=PagingConfig, kw={"device": "cpu"}, f32="float32"),
}

AGGS = {
    "sum": lambda S: S["fn"].SumAggregator(S["f32"]),
    "min": lambda S: S["fn"].MinAggregator(S["f32"]),
    "max": lambda S: S["fn"].MaxAggregator(S["f32"]),
    "avg": lambda S: S["fn"].AvgAggregator(S["f32"]),
    "lambda": lambda S: S["fn"].LambdaReduce(lambda a, b: a + b,
                                             np.float32(0.0)),
}
ASSIGNERS = {
    "tumbling": lambda S: S["win"].TumblingEventTimeWindows.of(100),
    "sliding": lambda S: S["win"].SlidingEventTimeWindows.of(300, 100),
    "global": lambda S: S["win"].GlobalWindows.create(),
}
TRIGGERS = {
    "purging": lambda S: S["trig"].CountTrigger.of(3, purge=True),
    "running": lambda S: S["trig"].CountTrigger.of(3, purge=False),
    "wrapped": lambda S: S["trig"].PurgingTrigger.of(
        S["trig"].CountTrigger.of(2)),
    "time": lambda S: None,
}
#: (assigner, trigger, aggregate) per case
CASES = {
    "tumbling-purging": ("tumbling", "purging", "sum"),
    "tumbling-running": ("tumbling", "running", "sum"),
    "tumbling-wrapped-min": ("tumbling", "wrapped", "min"),
    "sliding-running": ("sliding", "running", "sum"),
    "sliding-running-max": ("sliding", "running", "max"),
    "sliding-purging": ("sliding", "purging", "sum"),
    "sliding-purging-avg": ("sliding", "purging", "avg"),
    "global-purging": ("global", "purging", "sum"),
    "global-running": ("global", "running", "sum"),
    "global-wrapped-min": ("global", "wrapped", "min"),
    "global-never": ("global", "time", "sum"),
    "tumbling-purging-lambda": ("tumbling", "purging", "lambda"),
    "sliding-running-lambda": ("sliding", "running", "lambda"),
    "lambda-tumbling": ("tumbling", "time", "lambda"),
    "lambda-sliding": ("sliding", "time", "lambda"),
}
SNAP_AT = 5


@pytest.fixture(autouse=True)
def _pinned(verdicts):  # noqa: F811
    verdicts(taxed=False, shards=1, super_shards=1, depth=1, probe=False)
    prev = {s: S["dh"].get_monitor(create=False) for s, S in SIDES.items()}
    yield
    for s, S in SIDES.items():
        S["dh"].set_monitor(prev[s])
        S["chaos"].uninstall()


def _make(side, case, D=0, **kw):
    """One package's operator for ``case``: the device tier (count
    triggers and generic aggregates have no host tier), a small initial
    key capacity and pane ring so both grow; ``D`` > 0 builds the mesh."""
    S = SIDES[side]
    assigner, trigger, agg = CASES[case]
    kw = {**dict(key_column="k", value_column="v", allowed_lateness_ms=100,
                 initial_key_capacity=64, initial_panes=1,
                 emit_tier="device", snapshot_source="device",
                 device_probe="off", native_shards=1,
                 trigger=TRIGGERS[trigger](S)), **kw}
    args = (ASSIGNERS[assigner](S), AGGS[agg](S))
    if D:
        op = S["Mesh"](*args, mesh=S["mesh"](D), **kw)
    else:
        op = S["Op"](*args, **kw, **S["kw"])
    op.open(S["fn"].RuntimeContext())
    return op


def _stream(seed=7, n_batches=12, bsz=300):
    """Seeded batches: keys widen over time, event time advances 60 ms a
    batch, batch 8 is out of order, a watermark after every third batch."""
    rng = np.random.default_rng(seed)
    out, t = [], 0
    for i in range(n_batches):
        keys = rng.integers(0, 40 + 25 * i, bsz).astype(np.int64)
        vals = (rng.standard_normal(bsz) * 10).astype(np.float32)
        if i == 8:
            ts = np.sort(rng.integers(t - 250, t, bsz)).astype(np.int64)
        else:
            ts = t + np.sort(rng.integers(0, 60, bsz)).astype(np.int64)
            t += 60
        out.append((keys, vals, ts, int(t) - 1 if i % 3 == 2 else None))
    return out


STREAM = _stream()


def _drive(side, op, stream=STREAM, start=0, snap_at=SNAP_AT):
    """Fires as (call, batch), the snapshot after batch ``snap_at``."""
    S = SIDES[side]
    fired, snap = [], None
    for i, (keys, vals, ts, wm) in enumerate(stream):
        if i < start:
            continue
        out = op.process_batch(S["RB"]({"k": keys, "v": vals},
                                       timestamps=ts))
        if wm is not None:
            out += op.process_watermark(S["WM"](wm))
        if i == snap_at:
            out += op.prepare_snapshot_pre_barrier()
            snap = op.snapshot_state()
        fired += [(i, b) for b in out]
    fired += [(len(stream), b) for b in op.end_input()]
    return fired, snap


def _digests(fired):
    """Per non-empty fire: the call, then every column's and the
    timestamps' dtype and bytes."""
    out = []
    for i, b in fired:
        if not len(b):
            continue
        cols = tuple((c, np.asarray(b.column(c)).dtype.str,
                      np.asarray(b.column(c)).tobytes())
                     for c in sorted(b.columns))
        out.append((i, cols, np.asarray(b.timestamps).tobytes()))
    return out


def _assert_snaps_equal(got, want):
    """Bit for bit, the count and value baselines included."""
    for k in ("pane_base", "max_pane", "last_fired_window", "watermark",
              "late_dropped", "P", "key_index_kind"):
        assert got.get(k) == want.get(k), k
    assert np.array_equal(got["key_index"]["reverse"],
                          want["key_index"]["reverse"])
    for k in ("panes", "counts"):
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
        assert np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes()
    for g, w in zip(got["leaves"], want["leaves"], strict=True):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    gcb, wcb = got.get("count_baselines", {}), want.get("count_baselines", {})
    assert sorted(gcb) == sorted(wcb)
    for w in wcb:
        assert gcb[w].dtype == wcb[w].dtype == np.int64
        assert np.array_equal(gcb[w], wcb[w])
    gvb, wvb = got.get("value_baselines", {}), want.get("value_baselines", {})
    assert sorted(gvb) == sorted(wvb)
    for w in wvb:
        for g, v in zip(gvb[w], wvb[w], strict=True):
            assert g.dtype == v.dtype and g.tobytes() == v.tobytes()


_JAX_RUNS = {}


def _jax_run(case):
    if case not in _JAX_RUNS:
        _JAX_RUNS[case] = _drive("jax", _make("jax", case))
    return _JAX_RUNS[case]


# ---------------------------------------------------------------------------
# fires and snapshots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_fires_and_snapshots_bit_equal_jax(case):
    jfired, jsnap = _jax_run(case)
    pfired, psnap = _drive("port", _make("port", case))
    assert _digests(pfired) == _digests(jfired)
    _assert_snaps_equal(psnap, snapshot_from_jax(jsnap))


def test_the_cases_fire_and_keep_their_registers():
    """The stream makes every count case fire, grow keys and panes, and
    keep the registers its trigger needs (checked on the port)."""
    for case, (assigner, trigger, agg) in CASES.items():
        op = _make("port", case)
        fired, snap = _drive("port", op)
        if case == "global-never":
            assert not _digests(fired)
            continue
        assert _digests(fired), case
        assert op._K > 64, case
        running = trigger == "running"
        assert bool(snap.get("count_baselines")) == (
            trigger != "time" and (running or assigner == "sliding")), case
        assert bool(snap.get("value_baselines")) == (
            assigner == "sliding" and trigger == "purging"), case


@pytest.mark.parametrize("pipeline_depth", [0, 2])
@pytest.mark.parametrize("case", ["lambda-tumbling", "lambda-sliding"])
def test_lambda_reduce_window_pipelined_and_serial(case, pipeline_depth):
    """``LambdaReduce`` (no scatter kinds) takes the generic fold on the
    device tier, serial or pipelined, bit-equal to JAX's serial run."""
    jfired, jsnap = _jax_run(case)
    op = _make("port", case, pipeline_depth=pipeline_depth)
    assert op.kinds is None and op.emit_tier == "device"
    pfired, psnap = _drive("port", op)
    assert _digests(pfired) == _digests(jfired)
    _assert_snaps_equal(psnap, snapshot_from_jax(jsnap))


@pytest.mark.parametrize("lane", ["async_fire", "paging", "superbatch"])
def test_lambda_reduce_on_the_other_device_tier_lanes(lane):
    """The generic fold under ``async_fire``, a paged ring of 128 rows (the
    keys outgrow it) and a forced super-batch (which the generic fold does
    not stage: JAX's device tier never does), bit-equal to JAX's.  An async
    fire surfaces when its download is ready, which JAX's asynchronous CPU
    dispatch may report a call later than the port: there the fires are
    compared in order, each at a call no later than JAX's."""
    outs = []
    for side, S in SIDES.items():
        kw = {"async_fire": dict(async_fire=True),
              "paging": dict(paging=S["Paging"](capacity=128)),
              "superbatch": dict(superbatch=4)}[lane]
        op = _make(side, "lambda-tumbling", **kw)
        fired, _ = _drive(side, op)
        outs.append(_digests(fired))
    jax_d, port_d = outs
    if lane == "async_fire":
        assert [d[1:] for d in port_d] == [d[1:] for d in jax_d]
        assert all(p[0] <= j[0] for p, j in zip(port_d, jax_d))
    else:
        assert port_d == jax_d
    assert port_d
    if lane == "superbatch":
        assert op.fused_stats()["depth"] == 1


@pytest.mark.parametrize("case", ["tumbling-purging", "global-purging"])
def test_count_triggers_stay_serial_and_unstaged(case):
    """Count triggers read the counts after every batch: no pipeline and
    no super-batch, as in JAX, and the same fires."""
    op = _make("port", case, pipeline_depth=2, superbatch=4)
    pfired, _ = _drive("port", op)
    assert op._pipe is None and op.fused_stats()["depth"] == 1
    assert _digests(pfired) == _digests(_jax_run(case)[0])


# ---------------------------------------------------------------------------
# restores across packages, rescales
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["tumbling-running", "sliding-running",
                                  "sliding-purging-avg", "global-running",
                                  "global-purging", "lambda-sliding"])
def test_restore_across_packages_both_ways(case):
    """A snapshot taken mid-stream by either package restores into the
    other, which then fires what the writer's own run fired."""
    jfired, jsnap = _jax_run(case)
    pfired, psnap = _drive("port", _make("port", case))
    after = [(i, b) for i, b in jfired if i > SNAP_AT]
    port = _make("port", case)
    port.restore_state(snapshot_from_jax(jsnap))
    got, _ = _drive("port", port, start=SNAP_AT + 1, snap_at=-1)
    assert _digests(got) == _digests(after)
    jax_op = _make("jax", case)
    jax_op.restore_state(snapshot_to_jax(psnap))
    got, _ = _drive("jax", jax_op, start=SNAP_AT + 1, snap_at=-1)
    assert _digests(got) == _digests([(i, b) for i, b in pfired
                                      if i > SNAP_AT])


@pytest.mark.parametrize("case", ["sliding-running", "global-running",
                                  "sliding-purging"])
def test_rescale_split_and_merge_carry_baselines(case):
    """Split into 2 by key group and merged back, the count baselines
    travel with their keys' rows in both packages alike; each package's
    merged snapshot restores and fires as the other's."""
    _, jsnap = _jax_run(case)
    _, psnap = _drive("port", _make("port", case))
    jparts = JaxOp.split_snapshot(jsnap, 128, 2)
    pparts = WindowAggOperator.split_snapshot(psnap, 128, 2)
    assert any(p.get("count_baselines") for p in pparts)
    for jp, pp in zip(jparts, pparts, strict=True):
        _assert_snaps_equal(pp, snapshot_from_jax(jp))
    jmerged = JaxOp.merge_snapshots(jparts)
    pmerged = WindowAggOperator.merge_snapshots(pparts)
    _assert_snaps_equal(pmerged, snapshot_from_jax(jmerged))
    port = _make("port", case)
    port.restore_state(pmerged)
    jax_op = _make("jax", case)
    jax_op.restore_state(jmerged)
    got, _ = _drive("port", port, start=SNAP_AT + 1, snap_at=-1)
    want, _ = _drive("jax", jax_op, start=SNAP_AT + 1, snap_at=-1)
    assert _digests(got) == _digests(want) and _digests(got)


# ---------------------------------------------------------------------------
# construction, refusals, the watchdog
# ---------------------------------------------------------------------------

def test_the_generic_and_count_refusals_are_lifted():
    assert "generic" not in _LATER and "count" not in _LATER
    # (the evolution refusal went with the heap slice's state/evolution.py)
    # (object keys and processing time went with the object-key and the
    # local-job slices, late side outputs with the rest of the local job
    # path, incremental snapshots with the checkpoint slice, queryable
    # views with the serving slice)
    assert set(_LATER) == set()


@pytest.mark.parametrize("side", list(SIDES))
def test_purging_sliding_needs_an_invertible_aggregate(side):
    S = SIDES[side]
    with pytest.raises(NotImplementedError, match="INVERTIBLE"):
        S["Op"](S["win"].SlidingEventTimeWindows.of(2000, 1000),
                S["fn"].MinAggregator(S["f32"]), key_column="k",
                value_column="v", trigger=S["trig"].CountTrigger.of(
                    2, purge=True), **S["kw"])


@pytest.mark.parametrize("case", ["tumbling-purging", "global-never",
                                  "lambda-tumbling"])
def test_no_host_tier_and_no_paging_for_these_cases(case):
    """Count triggers, GlobalWindows and generic aggregates resolve the
    device tier under "auto" and refuse the host tier (ValueError) in both
    packages; count triggers and GlobalWindows refuse paging too."""
    for side in SIDES:
        op = _make(side, case, emit_tier="auto", snapshot_source="auto")
        assert op.emit_tier == "device"
        with pytest.raises(ValueError):
            _make(side, case, emit_tier="host", snapshot_source="mirror")
    if case != "lambda-tumbling":
        for side, S in SIDES.items():
            with pytest.raises(ValueError, match="paging"):
                _make(side, case, paging=S["Paging"](capacity=16))


def _wedge(side, case):
    S = SIDES[side]
    cfg = S["dh"].WatchdogConfig(
        deadline_floor_s=0.25, first_dispatch_grace_s=0.3,
        backoff_initial_s=0.001, backoff_max_s=0.01,
        probe_backoff_initial_s=0.02, probe_backoff_max_s=0.1)
    mon = S["dh"].DeviceHealthMonitor(cfg, heal_async=False)
    S["dh"].set_monitor(mon)
    op = _make(side, case)
    inj = S["chaos"].FaultInjector(seed=8)
    sched = inj.inject("device.dispatch", S["chaos"].WedgedDevice(at=1))
    with S["chaos"].installed(inj):
        with pytest.raises(S["dh"].DeviceQuarantinedError):
            op.process_batch(S["RB"](
                {"k": np.arange(8, dtype=np.int64) % 3,
                 "v": np.ones(8, np.float32)},
                timestamps=np.arange(8, dtype=np.int64)))
    sched.heal()
    assert mon.quarantined
    return op.device_health_stats()["quarantine_migrations"]


@pytest.mark.parametrize("case", ["lambda-tumbling", "tumbling-purging",
                                  "global-purging"])
def test_a_wedge_reraises_as_jax(case):
    """A wedged card under a generic aggregate, a count trigger or
    GlobalWindows re-raises (no host tier to migrate to), as JAX's does."""
    assert _wedge("port", case) == _wedge("jax", case) == 0


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def _mesh_feed(n=8, bsz=600, seed=21):
    """A watermark after every batch (``tests/test_mesh_invariance.py``)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        keys = rng.integers(0, 400, bsz).astype(np.int64)
        vals = (rng.standard_normal(bsz) * 3).astype(np.float32)
        ts = np.sort(rng.integers(i * 500, i * 500 + 700, bsz)).astype(
            np.int64)
        out.append((keys, vals, ts, i * 500 - 1))
    return out


MESH_FEED = _mesh_feed()


def _mesh_run(side, case, D):
    op = _make(side, case, D=D, initial_key_capacity=256)
    fired, snap = _drive(side, op, stream=MESH_FEED, snap_at=4)
    return _digests(fired), snap


@pytest.mark.parametrize("D", [1, 2, 4])
def test_lambda_reduce_on_the_mesh_bit_equal_jax(D):
    """Each block folds its exchanged rows through the generic scan over
    its local ids, as each of JAX's blocks does."""
    pd, psnap = _mesh_run("port", "lambda-tumbling", D)
    jd, jsnap = _mesh_run("jax", "lambda-tumbling", D)
    assert pd == jd and pd
    _assert_snaps_equal(densify_keyed_snapshot(psnap),
                        densify_keyed_snapshot(snapshot_from_jax(jsnap)))


def test_purging_count_trigger_on_the_mesh_bit_equal_jax():
    """JAX's mesh inherits count triggers from its base operator; the
    port's fires the same cells over its two blocks."""
    pd, psnap = _mesh_run("port", "tumbling-purging", 2)
    jd, jsnap = _mesh_run("jax", "tumbling-purging", 2)
    assert pd == jd and pd


@pytest.mark.parametrize("case", ["lambda-tumbling", "lambda-sliding",
                                  "tumbling-purging", "global-running"])
def test_placement_sharded_state_equals_the_single_ring(case):
    """``sharding=state_sharding(mesh)`` (JAX's placement-only control,
    one partitioned step over global ids): the generic scan runs over the
    global cells and each of the 4 blocks writes its own segment ends;
    count fires read every block.  Fires and snapshots equal the single
    ring's bit for bit."""
    want, wsnap = _drive("port", _make("port", case))
    sharding = pmesh.state_sharding(pmesh.make_mesh(devices=["cpu"] * 4))
    op = _make("port", case, sharding=sharding)
    got, snap = _drive("port", op)
    assert len(op._counts) == 4
    assert _digests(got) == _digests(want) and _digests(got)
    _assert_snaps_equal(densify_keyed_snapshot(snap), wsnap)

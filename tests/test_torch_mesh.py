"""Port parity for the mesh operator: ``flink_tpu_torch``'s
``MeshWindowAggOperator`` against ``flink_tpu``'s on the CPU, on the feed of
``tests/test_mesh_invariance.py`` (seeded keys and values, a watermark after
every batch, late drops, a mid-run snapshot, ``end_input``).

The JAX mesh runs on the conftest's 8-device CPU mesh (``make_mesh(D)``);
the port's is ``make_mesh(devices=["cpu"] * D)``: D row blocks owned by one
operator.  Both route every record through a stable bucketed exchange to
the block that owns its key and fold in row order, so fires (keys and
result bytes, in order), snapshots (slice by slice) and counters are
compared BIT FOR BIT, across mesh sizes 1, 2 and 4 and across the two
packages.  The quarantine case compares f64 value sums, as its JAX
counterpart does (a degraded device tier emits the mirror's f64 twins).

Every verdict is pinned and restored (``verdicts`` of
``test_torch_calibration.py``): JAX's ``device_probe="auto"`` measurement
imports ``jax.experimental.enable_x64``, which jax 0.9 lacks, so the JAX
side always runs with its probe lane pinned, under the ``_jax_x64`` shim
where the lane is on.  Each case passes alone and in any order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.core.batch import Watermark as JaxWatermark
from flink_tpu.core.functions import RuntimeContext as JaxContext
from flink_tpu.core.functions import SumAggregator as JaxSum
from flink_tpu.operators.window_agg import WindowAggOperator as JaxOp
from flink_tpu.parallel import mesh as jmesh
from flink_tpu.parallel.mesh_runtime import MeshWindowAggOperator as JaxMesh
from flink_tpu.runtime import device_health as jdh
from flink_tpu.state import shard_layout as jsl
from flink_tpu.state.paging import PagingConfig as JaxPaging
from flink_tpu.testing import chaos as jchaos
from flink_tpu.windowing.assigners import TumblingEventTimeWindows as JaxTumbling
from flink_tpu_torch.core.batch import RecordBatch, Watermark
from flink_tpu_torch.core.functions import RuntimeContext, SumAggregator
from flink_tpu_torch.interop import snapshot_from_jax, snapshot_to_jax
from flink_tpu_torch.operators.window_agg import WindowAggOperator
from flink_tpu_torch.parallel import mesh as pmesh
from flink_tpu_torch.parallel.mesh_runtime import MeshWindowAggOperator
from flink_tpu_torch.runtime import device_health as pdh
from flink_tpu_torch.state import shard_layout as psl
from flink_tpu_torch.state.paging import PagingConfig
from flink_tpu_torch.testing import chaos as pchaos
from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows
from test_torch_calibration import _jax_x64, verdicts  # noqa: F401

WINDOW_MS = 1000

SIDES = {
    "jax": dict(Op=JaxOp, Mesh=JaxMesh, mesh=jmesh.make_mesh,
                Tumbling=JaxTumbling, Agg=lambda: JaxSum(jnp.float32),
                RB=JaxBatch, WM=JaxWatermark, Ctx=JaxContext,
                Paging=JaxPaging, dh=jdh, chaos=jchaos, kw={}),
    "port": dict(Op=WindowAggOperator, Mesh=MeshWindowAggOperator,
                 mesh=lambda D: pmesh.make_mesh(devices=["cpu"] * D),
                 Tumbling=TumblingEventTimeWindows, Agg=SumAggregator,
                 RB=RecordBatch, WM=Watermark, Ctx=RuntimeContext,
                 Paging=PagingConfig, dh=pdh, chaos=pchaos,
                 kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _pinned(verdicts):  # noqa: F811
    """Every verdict pinned (none measured) and restored; both packages'
    monitors and injectors put back."""
    verdicts(taxed=False, shards=1, super_shards=1, depth=1, probe=False)
    prev = {s: S["dh"].get_monitor(create=False) for s, S in SIDES.items()}
    yield
    for s, S in SIDES.items():
        S["dh"].set_monitor(prev[s])
        S["chaos"].uninstall()


def _mk(side, D, tier="host", sync="scatter", paging=None, **kw):
    """The window operator of one package at mesh size D (1: the
    single-device operator)."""
    S = SIDES[side]
    if paging is not None:
        tier = "device"
        kw["paging"] = S["Paging"](**paging)
    kw.setdefault("device_probe", "off")
    kw.update(key_column="k", value_column="v", emit_tier=tier,
              snapshot_source="mirror" if tier == "host" else "device",
              device_sync=sync if tier == "host" else "scatter")
    if D == 1:
        op = S["Op"](S["Tumbling"].of(WINDOW_MS), S["Agg"](), **kw,
                     **S["kw"])
    else:
        op = S["Mesh"](S["Tumbling"].of(WINDOW_MS), S["Agg"](),
                       mesh=S["mesh"](D), **kw)
    op.open(S["Ctx"]())
    return op


def _digests(out):
    """Per fire: window, row count, the key and result columns' bytes."""
    return [(int(np.asarray(b.column("window_start"))[0]), len(b),
             np.asarray(b.column("k")).tobytes(),
             np.asarray(b.column("result")).tobytes())
            for b in out if hasattr(b, "columns") and "result" in b.columns]


def _counters(op):
    c = {"late_dropped": op.late_dropped,
         "num_keys": op.key_index.num_keys if op.key_index else 0,
         "watermark": op.watermark,
         "last_fired_window": op.last_fired_window,
         "device_health": op.device_health_stats()}
    probe = op.device_probe_stats()
    c["probe"] = {k: probe[k] for k in ("enabled", "probe_hits",
                                        "probe_misses", "miss_inserts")}
    fused = op.fused_stats()
    c["fused"] = {k: fused[k] for k in ("flushes", "staged_batches",
                                        "host_super_passes")}
    if op.paging_stats() is not None:
        c["paging"] = op.paging_stats()
    return c


def _run(side, op, seed=3, n_batches=6, nk=3000, B=4096, snap_at=None,
         late_every=0, keys_fn=None):
    """The seeded feed with per-batch watermarks (and late records), an
    optional mid-run snapshot, ending with end_input."""
    S = SIDES[side]
    rng = np.random.default_rng(seed)
    out, snap = [], None
    for i in range(n_batches):
        k = (keys_fn(rng, B) if keys_fn is not None
             else rng.integers(0, nk, B).astype(np.int64))
        v = rng.random(B).astype(np.float32)
        ts = i * 500 + np.sort(rng.integers(0, 500, B)).astype(np.int64)
        if late_every and i and i % late_every == 0:
            ts[: B // 8] -= 2500          # beyond-lateness drops
        out += op.process_batch(S["RB"]({"k": k, "v": v}, timestamps=ts))
        out += op.process_watermark(S["WM"](int(ts.max()) - 1))
        if snap_at == i:
            out += op.prepare_snapshot_pre_barrier()
            snap = op.snapshot_state()
    out += op.end_input()
    return _digests(out), snap, _counters(op)


def _jax_run(*args, **kw):
    with _jax_x64():
        return _run("jax", *args, **kw)


# ---------------------------------------------------------------------------
# tier invariance: mesh sizes 1, 2, 4 in both packages, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier,sync", [("host", "scatter"),
                                       ("host", "deferred"),
                                       ("device", "scatter")])
def test_mesh_size_invariance_by_tier_equals_jax(tier, sync):
    ref, _, ref_counters = _jax_run(_mk("jax", 1, tier, sync), late_every=3)
    assert len(ref) >= 3
    for D in (2, 4):
        got, _, counters = _jax_run(_mk("jax", D, tier, sync), late_every=3)
        assert got == ref and counters == ref_counters
    for D in (1, 2, 4):
        op = _mk("port", D, tier, sync)
        got, _, counters = _run("port", op, late_every=3)
        assert got == ref, f"port digests diverge at D={D} ({tier}/{sync})"
        assert counters == ref_counters, f"port counters at D={D}"
        assert op.verify_mirror()


@pytest.mark.parametrize("probe", ["on", "off"])
@pytest.mark.parametrize("sync", ["scatter", "deferred"])
def test_mesh_probe_lane_equals_jax(sync, probe):
    """The host tier with the device probe on (one probe on position 0,
    the warm rows' delta fold and the replica fold through the exchange)
    and off, at D = 2 and 4, against JAX's mesh and the port's D = 1."""
    kw = dict(device_probe=probe, native_emit=True)
    ref = None
    for D in (2, 4):
        want = _jax_run(_mk("jax", D, "host", sync, **kw), late_every=3)
        op = _mk("port", D, "host", sync, **kw)
        got = _run("port", op, late_every=3)
        assert got[0] == want[0] and got[2] == want[2], f"D={D}"
        assert op.device_probe_stats()["enabled"] == int(probe == "on")
        assert op.verify_mirror()
        ref = ref or got
        assert got[0] == ref[0]
    single = _run("port", _mk("port", 1, "host", sync, **kw), late_every=3)
    assert single[0] == ref[0]


@pytest.mark.parametrize("lane", [dict(superbatch=4, device_probe="on"),
                                  dict(superbatch=4, device_probe="off"),
                                  dict(pipeline_depth=1, device_probe="on")],
                         ids=["superbatch-4-probe", "superbatch-4",
                              "pipeline-1"])
def test_mesh_superbatch_and_pipeline_equal_jax(lane):
    """Super-batches stage through the concatenated host pass (the mesh's
    one-step lane stays off, as in JAX); the pipeline runs the hot stage
    on a worker.  Fires and counters equal JAX's mesh at D = 2."""
    want = _jax_run(_mk("jax", 2, "host", "scatter", **lane), late_every=3)
    op = _mk("port", 2, "host", "scatter", **lane)
    got = _run("port", op, late_every=3)
    op.close()
    assert got[0] == want[0] and got[2] == want[2]
    if lane.get("superbatch", 1) > 1:
        assert got[2]["fused"]["host_super_passes"] > 0
        assert op.fused_stats()["scan_dispatches"] == 0
    base = _run("port", _mk("port", 1, "host", "scatter",
                            device_probe=lane["device_probe"]),
                late_every=3)
    assert got[0] == base[0]


def test_mesh_non_pow2_device_count_equals_jax():
    """D = 6: K rounds to lcm(pow2, 6); rows still split evenly."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 100, 777).astype(np.int64)
    outs = []
    for side in ("jax", "port"):
        S = SIDES[side]
        op = _mk(side, 6, "device", initial_key_capacity=64)
        out = op.process_batch(S["RB"]({"k": keys,
                                        "v": np.ones(777, np.float32)},
                                       timestamps=np.zeros(777, np.int64)))
        assert op._K % 6 == 0 and op._K == 192
        out += op.process_watermark(S["WM"](999))
        total = sum(float(np.asarray(b.column("result")).sum()) for b in out)
        assert total == 777.0
        outs.append(_digests(out))
    assert outs[0] == outs[1]
    port = _mk("port", 6, "host")
    got = _run("port", port, late_every=3, n_batches=4)
    want = _jax_run(_mk("jax", 6, "host"), late_every=3, n_batches=4)
    assert got[0] == want[0] and got[2] == want[2]
    assert [c.shape[0] for c in port._counts] == [port._K // 6] * 6


def test_mesh_zipf_skew_equals_jax():
    """Zipf keys: a few blocks take most rows, the bucket capacity grows
    to hold them, no row is lost."""
    zipf = lambda rng, B: rng.zipf(1.5, B).astype(np.int64) % 1000  # noqa
    want = _jax_run(_mk("jax", 4, "device"), keys_fn=zipf, n_batches=4)
    op = _mk("port", 4, "device")
    got = _run("port", op, keys_fn=zipf, n_batches=4)
    assert got[0] == want[0] and got[2] == want[2]
    single = _run("port", _mk("port", 1, "device"), keys_fn=zipf,
                  n_batches=4)
    assert got[0] == single[0]
    assert op._exchange_cap_hw > 4096 // 16    # skew: one bucket is large


@pytest.mark.parametrize("D", [2, 4])
def test_mesh_exchange_geometry_is_sticky(D):
    """Many batches of one geometry keep ONE exchange geometry (JAX's
    compile-once check): the capacity is a high-water, so value and skew
    wobble at a fixed batch size and key set adds none."""
    op = _mk("port", D, "device")
    rng = np.random.default_rng(0)
    nk, B = 1500, 2048
    warm_k = np.pad(np.arange(nk, dtype=np.int64), (0, B - nk), mode="edge")
    op.process_batch(RecordBatch({"k": warm_k, "v": np.zeros(B, np.float32)},
                                 timestamps=np.zeros(B, np.int64)))
    steady_k = rng.integers(0, nk, B).astype(np.int64)
    op.process_batch(RecordBatch({"k": steady_k,
                                  "v": np.ones(B, np.float32)},
                                 timestamps=np.full(B, 10, np.int64)))
    size = op.mesh_step_cache_size()
    assert size >= 1
    for i in range(5):
        op.process_batch(RecordBatch(
            {"k": rng.permutation(steady_k),
             "v": rng.random(B).astype(np.float32)},
            timestamps=np.full(B, 20 + i, np.int64)))
    assert op.mesh_step_cache_size() == size


def test_mesh_per_shard_probe_breakdown_equals_jax():
    """The C pass shards by the blocks' slot ranges and reports each
    shard's wall time (``phase_shard_ns``), as JAX's does."""
    sizes = {}
    for side in ("jax", "port"):
        S = SIDES[side]
        op = _mk(side, 2, "host", native_emit=True)
        rng = np.random.default_rng(0)
        B = 1 << 15   # past the C pass's parallel threshold
        for i in range(3):
            op.process_batch(S["RB"](
                {"k": rng.integers(0, 5000, B).astype(np.int64),
                 "v": np.ones(B, np.float32)},
                timestamps=np.full(B, i, np.int64)))
        op.flush_pipeline()
        per_shard = op.phase_shard_ns["probe_mirror"]
        assert per_shard.size >= 2 and int(per_shard.sum()) > 0
        sizes[side] = per_shard.size
        assert op._probe_shards()[:2] == (2, op._K // 2)
    assert sizes["port"] == sizes["jax"]


# ---------------------------------------------------------------------------
# snapshots: byte-equal slices, rescale across sizes and packages
# ---------------------------------------------------------------------------

def _assert_snap_bytes_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if k == jsl.SLICES_KEY:
            assert psl.slice_manifest(got) == jsl.slice_manifest(want)
            for a, b in zip(g, w):
                assert a["counts"].tobytes() == b["counts"].tobytes()
                assert a["counts"].dtype == b["counts"].dtype
                assert [l.tobytes() for l in a["leaves"]] == \
                    [np.asarray(l).tobytes() for l in b["leaves"]]
        elif k == "key_index":
            assert np.array_equal(g["reverse"], w["reverse"])
        elif k in ("panes", "counts"):
            assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
        elif k == "leaves":
            assert [np.asarray(l).tobytes() for l in g] == \
                [np.asarray(l).tobytes() for l in w]
        else:
            assert g == w, k


@pytest.mark.parametrize("tier", ["host", "device"])
@pytest.mark.parametrize("D", [2, 4])
def test_mesh_snapshot_slices_equal_jax(D, tier):
    _, want, _ = _jax_run(_mk("jax", D, tier), snap_at=3)
    _, got, _ = _run("port", _mk("port", D, tier), snap_at=3)
    assert psl.has_shard_slices(got)
    assert [m["shard"] for m in psl.slice_manifest(got)] == list(range(D))
    _assert_snap_bytes_equal(got, want)
    # the interop carries the slices unchanged, both ways
    _assert_snap_bytes_equal(snapshot_from_jax(want), got)
    _assert_snap_bytes_equal(snapshot_to_jax(got), want)


@pytest.mark.parametrize("d_from,d_to", [(4, 2), (2, 4), (4, 1), (1, 4)])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mesh_snapshot_rescales_across_sizes_and_packages(writer, d_from,
                                                          d_to):
    """A snapshot written at ``d_from`` by one package restores at ``d_to``
    in the other (and in its own) and replays bit for bit like the
    writer's own restore at its size."""
    reader = "port" if writer == "jax" else "jax"
    run = _jax_run if writer == "jax" else _run
    _, snap, _ = (run(_mk(writer, d_from), snap_at=3) if writer == "jax"
                  else run(writer, _mk(writer, d_from), snap_at=3))
    if d_from > 1:
        assert psl.has_shard_slices(snap)
    ref_op = _mk(writer, d_from)
    carry = snapshot_from_jax if writer == "jax" else snapshot_to_jax
    with _jax_x64():
        ref_op.restore_state(snap)
        ref_tail, _, _ = _run(writer, ref_op, seed=99, n_batches=3)
        other = _mk(reader, d_to)
        other.restore_state(carry(snap))
        tail, _, _ = _run(reader, other, seed=99, n_batches=3)
    assert tail == ref_tail
    own = _mk(writer, d_to)
    with _jax_x64():
        own.restore_state(snap)
        tail, _, _ = _run(writer, own, seed=99, n_batches=3)
    assert tail == ref_tail


def test_sliced_snapshot_restores_into_the_single_device_operator():
    _, snap, _ = _run("port", _mk("port", 4, "device"), snap_at=2)
    op = WindowAggOperator(TumblingEventTimeWindows.of(WINDOW_MS),
                           SumAggregator(), key_column="k", value_column="v",
                           device="cpu", emit_tier="device",
                           device_probe="off")
    op.open(RuntimeContext())
    op.restore_state(snap)        # the sliced format densifies on restore
    dense = op.snapshot_state()
    assert not psl.has_shard_slices(dense)
    back = psl.densify_keyed_snapshot(snap)
    assert dense["counts"].tobytes() == back["counts"].tobytes()
    assert dense["leaves"][0].tobytes() == back["leaves"][0].tobytes()


# ---------------------------------------------------------------------------
# paging on the mesh
# ---------------------------------------------------------------------------

def test_mesh_paging_invariance_64k_cap_256k_keys_equals_jax():
    """256k keys through a 64k-row resident ring at D = 2 (32k rows a
    block): fires and paging counters equal JAX's mesh and the port's
    D = 1."""
    kw = dict(seed=5, n_batches=10, nk=1 << 18, B=1 << 15)
    cap = dict(capacity=1 << 16)
    want = _jax_run(_mk("jax", 2, paging=cap), **kw)
    op = _mk("port", 2, paging=cap)
    got = _run("port", op, **kw)
    assert got[0] == want[0] and got[2] == want[2]
    single = _run("port", _mk("port", 1, paging=cap), **kw)
    assert got[0] == single[0] and got[2] == single[2]
    assert got[2]["paging"]["spilled_keys"] + \
        got[2]["paging"]["resident_keys"] > 1 << 16
    assert [c.shape[0] for c in op._counts] == [1 << 15] * 2
    op.close()


@pytest.mark.parametrize("d_from,d_to", [(1, 2), (2, 1), (2, 4)])
def test_mesh_paged_snapshot_rescales_across_packages(d_from, d_to):
    """Paged snapshots stay dense (the key-id space exceeds the ring) and
    restore across mesh sizes and packages."""
    cap = dict(capacity=2048)
    kw = dict(seed=5, n_batches=6, nk=6000, B=1024)
    _, jsnap, _ = _jax_run(_mk("jax", d_from, paging=cap), snap_at=3, **kw)
    _, psnap, _ = _run("port", _mk("port", d_from, paging=cap), snap_at=3,
                       **kw)
    assert not psl.has_shard_slices(psnap)
    assert psnap["paging_stats"] == jsnap["paging_stats"]
    _assert_snap_bytes_equal(snapshot_to_jax(psnap), snapshot_from_jax(jsnap))
    ref = _mk("jax", d_from, paging=cap)
    ref.restore_state(jsnap)
    want, _, _ = _jax_run(ref, seed=99, n_batches=2, nk=6000, B=1024)
    op = _mk("port", d_to, paging=cap)
    op.restore_state(snapshot_from_jax(jsnap))
    got, _, _ = _run("port", op, seed=99, n_batches=2, nk=6000, B=1024)
    assert got == want


# ---------------------------------------------------------------------------
# the whole-mesh degrade
# ---------------------------------------------------------------------------

def _vdigests(out):
    return [(int(np.asarray(b.column("window_start"))[0]), len(b),
             np.asarray(b.column("k")).tobytes(),
             float(np.asarray(b.column("result"), np.float64).sum()))
            for b in out if hasattr(b, "columns") and "result" in b.columns]


def _quarantine_pass(side, inject, tier="device", at=8):
    """The WedgedDevice nemesis at mesh size 2: the quarantine degrades
    the WHOLE mesh (the ring downloads block by block into the host value
    mirror), a checkpoint completes during the quarantine, the healed
    device re-promotes at the next checkpoint-aligned safe point."""
    S = SIDES[side]
    dh, ch = S["dh"], S["chaos"]
    dh.set_monitor(dh.DeviceHealthMonitor(
        dh.WatchdogConfig(deadline_floor_s=2.0), heal_async=False))
    inj = ch.FaultInjector(seed=3)
    sched = (inj.inject("device.dispatch", ch.WedgedDevice(at=at))
             if inject else None)
    op = _mk(side, 2, tier, device_probe="on" if tier == "host" else "off")
    rng = np.random.default_rng(7)
    out, snap_degraded, snap = [], False, None
    with ch.installed(inj), _jax_x64():
        for i in range(24):
            k = rng.integers(0, 64, 512).astype(np.int64)
            v = np.ones(512, np.float32)
            ts = i * 500 + np.sort(rng.integers(0, 500, 512)).astype(
                np.int64)
            out += op.process_batch(S["RB"]({"k": k, "v": v}, timestamps=ts))
            out += op.process_watermark(S["WM"](int(ts.max()) - 1))
            if inject and i == 12:
                op.prepare_snapshot_pre_barrier()
                snap = op.snapshot_state()
                snap_degraded = op._degraded
                sched.heal()
                dh.get_monitor().probe_now()
            if inject and i == 16:
                out += op.prepare_snapshot_pre_barrier()
        out += op.end_input()
    mon = dh.get_monitor().status()
    stats = op.device_health_stats()
    dispatches = op.fused_stats()["hot_dispatches"]
    op.close()
    return _vdigests(out), stats, mon, snap_degraded, snap, dispatches


@pytest.mark.chaos
@pytest.mark.parametrize("tier,at", [("device", 8), ("host", 6), ("host", 7),
                                     ("host", 8)],
                         ids=["device", "host-probe", "host-delta",
                              "host-update"])
def test_mesh_quarantine_degrades_whole_mesh_like_jax(tier, at):
    """The wedge on the device tier's fold, and on each of the host tier's
    three dispatches a batch (the probe, the delta fold, the replica
    fold: dispatches 6, 7, 8 are batch 2's)."""
    clean = _quarantine_pass("port", False, tier)[0]
    got = _quarantine_pass("port", True, tier, at)
    want = _quarantine_pass("jax", True, tier, at)
    assert clean == got[0] and len(clean) >= 10
    assert got[0] == want[0]
    assert got[1] == want[1] == {"degraded": 0, "quarantine_migrations": 1,
                                 "repromotions": 1}
    for k in ("quarantines", "heals", "watchdog_timeouts"):
        assert got[2][k] == want[2][k] == 1, k
    assert got[3] and want[3], "the checkpoint did not run degraded"
    assert got[5] == want[5]
    # the degraded snapshot: the mirror's dense state, sliced by shard
    a, b = psl.densify_keyed_snapshot(got[4]), jsl.densify_keyed_snapshot(
        want[4])
    assert a["counts"].tobytes() == b["counts"].tobytes()
    assert a["leaves"][0].tobytes() == b["leaves"][0].tobytes()

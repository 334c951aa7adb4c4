"""Port parity for the slice as a whole: ``flink_tpu_torch``'s
``WindowAggOperator`` against ``flink_tpu``'s on one seeded stream.

JAX side: the host emit tier with the numpy mirror, scatter sync, the device
probe on, serial (``pipeline_depth=0``, ``superbatch=1``), built like
``tests/test_device_keyindex.py``'s ``_mk_op``; JAX runs its probe through
``lax_probe`` on the CPU.  Port side: the same configuration with
``device="cpu"``.  The stream follows that file's ``_seeded_run``: window 100,
1500 keys, 4000-row batches, key growth from ``initial_key_capacity=1<<10``,
plus one out-of-order batch that the late-drop gate partly drops.

The JAX KeyIndex delegates to the C keydict and the port's is numpy; both
number new keys in order of first occurrence, so slot ids agree, but the
comparison does not rest on it: fires are compared per window sorted by
key, and snapshots as key -> cell mappings.  Results are held to
rtol=atol=1e-6 because the scatter order may differ; on the CPU they are in
fact bit-equal today (both fold in row order into f64 mirrors).

The reference's probe lane imports ``jax.experimental.enable_x64``, which
the installed jax (0.9) has moved to ``jax.enable_x64``; the ``_jax_x64``
shim below restores the old name for the duration of each JAX run.  Nothing
in ``flink_tpu`` changes.
"""

import contextlib
import inspect

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
from flink_tpu_torch.operators.window_agg import WindowAggOperator
from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows
from test_torch_calibration import verdicts  # noqa: F401 — the fixture

RTOL = ATOL = 1e-6
SNAP_AT = 6


@contextlib.contextmanager
def _jax_x64():
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64",
                       lambda new_val=True: jax.enable_x64(new_val),
                       raising=False)
        yield


def _batches(n_batches=10, nk=1500, b=4000, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        keys = rng.integers(0, nk, b).astype(np.int64)
        vals = rng.random(b).astype(np.float32)
        if i == 8:
            # out of order: straddles an already-fired window, half late
            ts = 250 + np.sort(rng.integers(0, 100, b)).astype(np.int64)
        else:
            ts = i * 50 + np.sort(rng.integers(0, 50, b)).astype(np.int64)
        out.append((keys, vals, ts))
    return out


BATCHES = _batches()


def _jax_op(device_probe="on", **kw):
    op = JaxOp(JaxTumbling.of(100), JaxSum(jnp.float32), key_column="k",
               value_column="v", emit_tier="host", snapshot_source="mirror",
               device_sync="scatter", native_emit=False,
               device_probe=device_probe, pipeline_depth=0, superbatch=1,
               **kw)
    op.open(JaxContext())
    return op


def _port_op(device_probe="on", **kw):
    op = WindowAggOperator(TumblingEventTimeWindows.of(100), SumAggregator(),
                           key_column="k", value_column="v",
                           emit_tier="host", snapshot_source="mirror",
                           device_sync="scatter", native_emit=False,
                           device_probe=device_probe, pipeline_depth=0,
                           superbatch=1, device="cpu", **kw)
    op.open(RuntimeContext())
    return op


def _drive(op, batches, RB, WM, snap_at=None, watermark_every=1):
    """Feed batches + watermarks (after every ``watermark_every``-th
    batch); returns (fires before the snapshot, fires after it, snapshot)."""
    before, after, snap = [], [], None
    for i, (keys, vals, ts) in enumerate(batches):
        out = op.process_batch(RB({"k": keys, "v": vals}, timestamps=ts))
        if (i + 1) % watermark_every == 0:
            out += op.process_watermark(WM(int(ts.max()) - 1))
        (after if snap is not None else before).extend(out)
        if i == snap_at:
            op.prepare_snapshot_pre_barrier()
            snap = op.snapshot_state()
    (after if snap is not None else before).extend(op.end_input())
    return before, after, snap


def _counters(op):
    s = op.device_probe_stats()
    return {"late_dropped": op.late_dropped,
            "num_keys": op.key_index.num_keys if op.key_index else 0,
            "watermark": op.watermark,
            "last_fired_window": op.last_fired_window,
            "probe_hits": s["probe_hits"], "probe_misses": s["probe_misses"]}


def _fires(out):
    """[(window_start, keys sorted, results by key, result dtype)]."""
    rows = []
    for b in out:
        keys = np.asarray(b.column("k"))
        order = np.argsort(keys, kind="stable")
        res = np.asarray(b.column("result"))
        rows.append((int(np.asarray(b.column("window_start"))[0]),
                     keys[order], res[order], res.dtype))
    return rows


def _assert_fires_equal(got, want):
    got, want = _fires(got), _fires(want)
    assert [g[0] for g in got] == [w[0] for w in want]
    for (ws, gk, gr, gd), (_, wk, wr, wd) in zip(got, want):
        assert np.array_equal(gk, wk), f"keys of window {ws}"
        assert gd == wd, f"result dtype of window {ws}"
        np.testing.assert_allclose(gr, wr, rtol=RTOL, atol=ATOL)


def _cells(snap):
    """key -> (counts row, leaf rows) of a dense snapshot."""
    keys = np.asarray(snap["key_index"]["reverse"])
    order = np.argsort(keys)
    return (keys[order], np.asarray(snap["counts"])[order],
            [np.asarray(l)[order] for l in snap["leaves"]])


def _assert_snap_equivalent(got, want):
    for k in ("pane_base", "max_pane", "last_fired_window", "watermark",
              "late_dropped", "P", "key_index_kind", "leaf_schema"):
        assert got[k] == want[k], k
    assert np.array_equal(got["panes"], want["panes"])
    gk, gc, gl = _cells(got)
    wk, wc, wl = _cells(want)
    assert np.array_equal(gk, wk)
    assert gc.dtype == wc.dtype and np.array_equal(gc, wc)
    for g, w in zip(gl, wl):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def jax_run():
    with _jax_x64():
        op = _jax_op()
        before, after, snap = _drive(op, BATCHES, JaxBatch, JaxWatermark,
                                     SNAP_AT)
    return before, after, snap, _counters(op)


@pytest.fixture(scope="module")
def port_run():
    op = _port_op()
    before, after, snap = _drive(op, BATCHES, RecordBatch, Watermark, SNAP_AT)
    assert op.verify_mirror()
    return before, after, snap, _counters(op)


def test_fires_equal_jax(jax_run, port_run):
    _assert_fires_equal(port_run[0] + port_run[1], jax_run[0] + jax_run[1])


def test_counters_equal_jax(jax_run, port_run):
    assert port_run[3] == jax_run[3]
    assert port_run[3]["late_dropped"] > 0          # the gate fired
    assert port_run[3]["late_dropped"] < 4000       # ... on part of a batch
    assert port_run[3]["probe_hits"] > 0 and port_run[3]["probe_misses"] > 0


def test_snapshots_equivalent(jax_run, port_run):
    _assert_snap_equivalent(port_run[2], snapshot_from_jax(jax_run[2]))


def test_probe_on_and_off_fire_alike(port_run):
    op = _port_op("off")
    before, after, _snap = _drive(op, BATCHES, RecordBatch, Watermark)
    _assert_fires_equal(before + after, port_run[0] + port_run[1])
    assert op.device_probe_stats()["enabled"] == 0
    assert op.verify_mirror()


def test_pane_ring_growth_matches_jax():
    """A 2-pane ring with watermarks only every 4th batch: the live span
    outgrows the ring, which doubles (draining the probe's delta ring into
    the mirror first) in both packages alike."""
    kw = dict(initial_panes=1)
    with _jax_x64():
        jop = _jax_op(**kw)
        jb, ja, jsnap = _drive(jop, BATCHES[:8], JaxBatch, JaxWatermark,
                               snap_at=6, watermark_every=4)
    pop = _port_op(**kw)
    pb, pa, psnap = _drive(pop, BATCHES[:8], RecordBatch, Watermark,
                           snap_at=6, watermark_every=4)
    assert psnap["P"] == jsnap["P"] > 2
    _assert_fires_equal(pb + pa, jb + ja)
    _assert_snap_equivalent(psnap, snapshot_from_jax(jsnap))
    assert pop.verify_mirror()


def test_state_carried_from_jax_into_the_port(jax_run):
    op = _port_op()
    op.restore_state(snapshot_from_jax(jax_run[2]))
    before, after, _ = _drive(op, BATCHES[SNAP_AT + 1:], RecordBatch,
                              Watermark)
    _assert_fires_equal(before + after, jax_run[1])
    assert op.late_dropped == jax_run[3]["late_dropped"]
    assert op.verify_mirror()


def test_state_carried_from_the_port_into_jax(port_run):
    with _jax_x64():
        op = _jax_op()
        op.restore_state(snapshot_to_jax(port_run[2]))
        before, after, _ = _drive(op, BATCHES[SNAP_AT + 1:], JaxBatch,
                                  JaxWatermark)
    _assert_fires_equal(before + after, port_run[1])
    assert op.late_dropped == port_run[3]["late_dropped"]


def test_interop_refuses_what_the_slice_does_not_carry(port_run):
    snap = dict(port_run[2])
    snap["__increment__"] = {"base": 1}
    with pytest.raises(ValueError, match="__increment__"):
        snapshot_from_jax(snap)
    snap = dict(port_run[2], key_index_kind="ObjectKeyIndex")
    with pytest.raises(ValueError, match="ObjectKeyIndex"):
        snapshot_to_jax(snap)


class _ProcessingTimeWindows(TumblingEventTimeWindows):
    """A processing-time assigner's declaration (the runtime-stack slice
    ports them)."""

    is_event_time = False


@pytest.mark.parametrize("kw", [
    {"queryable": "q"},
    # sharding is accepted since the mesh, count triggers since the
    # count-trigger slice
    {"assigner": _ProcessingTimeWindows(100)},
    {"late_output_tag": "late"},
])
def test_later_slices_refuse_honestly(kw):
    kw = dict(kw)
    assigner = kw.pop("assigner", TumblingEventTimeWindows.of(100))
    base = dict(key_column="k", value_column="v", device="cpu")
    with pytest.raises(NotImplementedError, match="not in this slice"):
        WindowAggOperator(assigner, SumAggregator(), **{**base, **kw})


#: options the calibration and pipelining slice lifted from the refusals:
#: (keyword arguments, pinned verdicts, the resolved lane after one batch)
LIFTED = {
    "device_sync-auto-healthy": (dict(device_sync="auto"),
                                 dict(taxed=False),
                                 dict(device_sync_mode="scatter")),
    "device_sync-auto-taxed": (dict(device_sync="auto"), dict(taxed=True),
                               dict(device_sync_mode="deferred")),
    "device_probe-auto-on": (dict(device_probe="auto"), dict(probe=True),
                             dict(probe=1)),
    "device_probe-auto-off": (dict(device_probe="auto"), dict(probe=False),
                              dict(probe=0)),
    "superbatch-0": (dict(superbatch=0), dict(depth=4), dict(depth=4)),
    "pipeline_depth-1": (dict(pipeline_depth=1), {}, dict(pipelined=True)),
    "native_emit-shards-0": (dict(native_emit=True, native_shards=0),
                             dict(shards=3), dict(native=True, shards=3)),
    "emit_tier-auto-cpu": (dict(emit_tier="auto", snapshot_source="auto"),
                           {}, dict(emit_tier="device",
                                    snapshot_source="device")),
}


@pytest.mark.parametrize("case", list(LIFTED))
def test_lifted_options_resolve_to_the_documented_lane(verdicts, case):
    """Each option the earlier slices refused now builds and resolves to
    its documented lane on the first batch (the host tier pinned with the
    probe on and scatter sync, except the option under test)."""
    kw, pins, want = LIFTED[case]
    verdicts(**{"taxed": False, "probe": True, **pins})
    base = dict(emit_tier="host", snapshot_source="mirror",
                device_sync="scatter", native_emit=False, device_probe="on",
                superbatch=1)
    op = WindowAggOperator(TumblingEventTimeWindows.of(100), SumAggregator(),
                           key_column="k", value_column="v", device="cpu",
                           **{**base, **kw})
    op.open(RuntimeContext())
    keys, vals, ts = BATCHES[0]
    op.process_batch(RecordBatch({"k": keys, "v": vals}, timestamps=ts))
    op.flush_pipeline()
    got = {"device_sync_mode": op.device_sync_mode,
           "probe": op.device_probe_stats()["enabled"],
           "depth": op.fused_stats()["depth"],
           "pipelined": op._pipe is not None,
           "native": op.native_mirror_active,
           "shards": op._nm_shards,
           "emit_tier": op.emit_tier,
           "snapshot_source": op.snapshot_source}
    assert {k: got[k] for k in want} == want
    assert op.key_index.num_keys == np.unique(keys).size
    op.close()


def test_constructor_defaults_equal_jax():
    """The same keyword arguments build the same lane: every parameter the
    JAX operator takes has the same default here (``device`` is the port's
    own)."""
    jax_params = inspect.signature(JaxOp.__init__).parameters
    port_params = inspect.signature(WindowAggOperator.__init__).parameters
    assert set(port_params) - set(jax_params) == {"device"}
    for name, param in jax_params.items():
        assert port_params[name].default == param.default, name
    from flink_tpu_torch.operators.window_agg import _LATER
    assert not {"auto", "pipeline"} & set(_LATER)


def test_fire_rows_match_an_independent_reference():
    """Fires hold the per-window np.bincount of the records that passed
    the late gate (no JAX involved)."""
    op = _port_op()
    fired = {}
    wm = -2 ** 63
    expect = {}
    for keys, vals, ts in BATCHES:
        late = (ts // 100) * 100 + 99 <= wm
        for w in np.unique(ts[~late] // 100):
            m = (~late) & (ts // 100 == w)
            e = expect.setdefault(int(w) * 100, np.zeros(1500))
            e += np.bincount(keys[m], weights=vals[m].astype(np.float64),
                             minlength=1500)
        for b in (op.process_batch(RecordBatch({"k": keys, "v": vals},
                                                timestamps=ts))
                  + op.process_watermark(Watermark(int(ts.max()) - 1))):
            fired.setdefault(int(b.column("window_start")[0]), []).append(b)
        wm = max(wm, int(ts.max()) - 1)
    for b in op.end_input():
        fired.setdefault(int(b.column("window_start")[0]), []).append(b)
    assert sorted(fired) == sorted(expect)
    for w, bs in fired.items():
        assert len(bs) == 1, f"window {w} fired {len(bs)} times"
        got = np.zeros(1500)
        got[np.asarray(bs[0].column("k"))] = np.asarray(bs[0].column("result"))
        np.testing.assert_allclose(got, expect[w], rtol=RTOL, atol=ATOL)


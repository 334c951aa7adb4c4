"""Port parity for late side outputs (``late_output_tag``, the API's
``side_output_late_data``): ``flink_tpu_torch``'s window operators against
``flink_tpu``'s on the CPU.

A seeded stream with per-batch watermarks moves part of some batches back
in event time: some rows within the allowed lateness (late re-fires), some
beyond it (the side output).  On every lane of the window operator (host
tier with the numpy or the C mirror, the device probe, deferred sync, the
super-batch, the pipeline; the device tier, its super-batch, pipeline,
``async_fire`` and paging; the mesh operator at 2 and 4 blocks) each
call's outputs are compared with JAX's BIT FOR BIT and in order: every fire
(window, keys, result bytes) and every ``TaggedBatch`` (tag, each column's
bytes, the timestamps).  ``late_dropped`` stays 0 with the tag, as the
reference's drop counter counts only what no side output takes; a twin
without the tag drops exactly the side output's rows and fires the same.
With ``async_fire`` the fires surface a call late: the side output still
leaves in its own call, right after the fires that call drains, as in
JAX's operator.

Every verdict is pinned and restored (``verdicts`` of
``test_torch_calibration.py``); the JAX side runs under its ``_jax_x64``
shim.  The JAX mesh runs on the conftest's CPU devices, the port's on
``["cpu"] * D``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_tpu import datastream as jds
from flink_tpu import windowing as jwin
from flink_tpu.core import functions as jfn
from flink_tpu.core.batch import OutputTag as JaxOutputTag
from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.core.batch import Watermark as JaxWatermark
from flink_tpu.operators.window_agg import WindowAggOperator as JaxOp
from flink_tpu.parallel import mesh as jmesh
from flink_tpu.parallel.mesh_runtime import MeshWindowAggOperator as JaxMesh
from flink_tpu.state.paging import PagingConfig as JaxPaging
from flink_tpu_torch import datastream as pds
from flink_tpu_torch import windowing as pwin
from flink_tpu_torch.core import functions as pfn
from flink_tpu_torch.core.batch import OutputTag, RecordBatch, Watermark
from flink_tpu_torch.interop import snapshot_from_jax, snapshot_to_jax
from flink_tpu_torch.operators.window_agg import WindowAggOperator
from flink_tpu_torch.parallel import mesh as pmesh
from flink_tpu_torch.parallel.mesh_runtime import MeshWindowAggOperator
from flink_tpu_torch.state.paging import PagingConfig
from test_torch_calibration import _jax_x64, verdicts  # noqa: F401

WINDOW_MS = 1000
LATENESS = 700
TAG = "late"

SIDES = {
    "jax": dict(Op=JaxOp, Mesh=JaxMesh, mesh=jmesh.make_mesh,
                win=jwin, fn=jfn, f32=jnp.float32, RB=JaxBatch,
                WM=JaxWatermark, Paging=JaxPaging, kw={},
                env=lambda **kw: jds.StreamExecutionEnvironment(**kw),
                Tag=JaxOutputTag),
    "port": dict(Op=WindowAggOperator, Mesh=MeshWindowAggOperator,
                 mesh=lambda D: pmesh.make_mesh(devices=["cpu"] * D),
                 win=pwin, fn=pfn, f32=torch.float32, RB=RecordBatch,
                 WM=Watermark, Paging=PagingConfig, kw={"device": "cpu"},
                 env=lambda **kw: pds.StreamExecutionEnvironment(
                     device="cpu", **kw),
                 Tag=OutputTag),
}

HOST = dict(emit_tier="host", snapshot_source="mirror", device_probe="off")
DEVICE = dict(emit_tier="device", snapshot_source="device",
              device_sync="scatter", device_probe="off")
#: every lane of the window operator that takes the late gate
LANES = {
    "host-numpy": dict(HOST, native_emit=False),
    "host-native": dict(HOST, native_emit=True),
    "host-probe": dict(HOST, native_emit=True, device_probe="on"),
    "host-deferred": dict(HOST, device_sync="deferred"),
    "host-superbatch": dict(HOST, superbatch=4),
    "host-pipeline": dict(HOST, pipeline_depth=2),
    "device": dict(DEVICE),
    "device-superbatch": dict(DEVICE, superbatch=4),
    "device-pipeline": dict(DEVICE, pipeline_depth=2),
    "paging": dict(DEVICE, paging=dict(capacity=512)),
    "mesh-2": dict(HOST, mesh=2),
    "mesh-4": dict(DEVICE, mesh=4),
}


@pytest.fixture(autouse=True)
def _pinned(verdicts):  # noqa: F811
    verdicts(taxed=False, shards=1, super_shards=1, depth=1, probe=False)


def _mk(side, tag=TAG, mesh=None, paging=None, **kw):
    S = SIDES[side]
    if paging is not None:
        kw["paging"] = S["Paging"](**paging)
    kw = dict(kw, key_column="k", value_column="v",
              allowed_lateness_ms=LATENESS, late_output_tag=tag)
    win = S["win"].TumblingEventTimeWindows.of(WINDOW_MS)
    agg = S["fn"].SumAggregator(S["f32"])
    if mesh is None:
        op = S["Op"](win, agg, **kw, **S["kw"])
    else:
        op = S["Mesh"](win, agg, mesh=S["mesh"](mesh), **kw)
    op.open(S["fn"].RuntimeContext())
    return op


def _stream(seed=5, n_batches=8, nk=3000, B=2048):
    """Seeded batches; from batch 3 on, every other batch moves 1/8 of its
    rows 2500 ms back (beyond the lateness) and 1/16 600 ms back (into the
    window the last watermark fired, within the lateness: late
    re-fires)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        k = rng.integers(0, nk, B).astype(np.int64)
        v = rng.random(B).astype(np.float32)
        ts = i * 500 + np.sort(rng.integers(0, 500, B)).astype(np.int64)
        if i >= 3 and i % 2 == 1:
            ts[: B // 8] -= 2500
            ts[B // 8: B // 8 + B // 16] -= 600
        out.append((k, v, ts))
    return out


STREAM = _stream()


def _view(e):
    """One output element's bits: a fire or a tagged batch."""
    if hasattr(e, "tag"):
        b = e.batch
        return ("late", e.tag,
                tuple((c, np.asarray(b.column(c)).dtype.str,
                       np.asarray(b.column(c)).tobytes())
                      for c in sorted(b.columns)),
                np.asarray(b.timestamps, np.int64).tobytes())
    return ("fire", int(np.asarray(e.column("window_start"))[0]), len(e),
            np.asarray(e.column("k")).tobytes(),
            np.asarray(e.column("result")).tobytes())


def _drive(side, op, stream=STREAM, snap_at=3):
    """Per call (a batch and its watermark), the views of what it
    returned; the mid-run snapshot; the counters."""
    S = SIDES[side]
    calls, snap = [], None
    for i, (k, v, ts) in enumerate(stream):
        out = op.process_batch(S["RB"]({"k": k, "v": v}, timestamps=ts))
        out += op.process_watermark(S["WM"](int(ts.max()) - 1))
        if i == snap_at:
            out += op.prepare_snapshot_pre_barrier()
            snap = op.snapshot_state()
        calls.append([_view(e) for e in out if len(getattr(e, "batch", e))])
    calls.append([_view(e) for e in op.end_input() if len(e)])
    return calls, snap, {"late_dropped": op.late_dropped,
                         "watermark": op.watermark,
                         "last_fired_window": op.last_fired_window}


def _run(side, **kw):
    op = _mk(side, **kw)
    if side == "jax":
        with _jax_x64():
            return _drive(side, op)
    return _drive(side, op)


def _late_rows(calls):
    return sum(int(np.frombuffer(v[3], np.int64).size)
               for c in calls for v in c if v[0] == "late")


def _fires(calls):
    return [v for c in calls for v in c if v[0] == "fire"]


@pytest.mark.parametrize("lane", list(LANES))
def test_late_side_output_equals_jax_on_every_lane(lane):
    want, jsnap, jcnt = _run("jax", **LANES[lane])
    got, psnap, pcnt = _run("port", **LANES[lane])
    assert got == want
    assert pcnt == jcnt and pcnt["late_dropped"] == 0
    assert psnap["late_dropped"] == jsnap["late_dropped"] == 0
    late = _late_rows(got)
    assert 0 < late < sum(len(k) for k, _, _ in STREAM)
    # the stream re-fires windows within the lateness as well
    starts = [v[1] for v in _fires(got)]
    assert len(starts) > len(set(starts))
    # without async fires nothing is pending when a batch comes, so its
    # side output leads the call, before the re-fires and the watermark's
    # fires (a paged batch splits, so its parts each ship their own)
    if "paging" not in LANES[lane]:
        for c in got:
            kinds = [v[0] for v in c]
            if "late" in kinds:
                assert kinds.index("late") == 0 and kinds.count("late") == 1


@pytest.mark.parametrize("lane", ["host-native", "device", "mesh-2"])
def test_untagged_twin_drops_what_the_tag_ships(lane):
    tagged, _, _ = _run("port", **LANES[lane])
    twin, snap, cnt = _run("port", tag=None, **LANES[lane])
    assert _fires(twin) == _fires(tagged)
    assert cnt["late_dropped"] == _late_rows(tagged) > 0
    assert not any(v[0] == "late" for c in twin for v in c)
    jtwin, jsnap, jcnt = _run("jax", tag=None, **LANES[lane])
    assert twin == jtwin and cnt == jcnt
    assert snap["late_dropped"] == jsnap["late_dropped"]


def test_the_side_output_is_the_beyond_lateness_rows_in_batch_order():
    """The tagged rows are exactly the input rows whose pane's cleanup time
    the watermark passed, with their keys, values and timestamps, in batch
    order (a numpy model of the gate)."""
    calls, _, _ = _run("port", **LANES["host-native"])
    wm = None
    want = []
    for k, v, ts in STREAM:
        if wm is not None:
            pane = ts // WINDOW_MS
            late = (pane + 1) * WINDOW_MS - 1 + LATENESS <= wm
            if late.any():
                want.append((k[late].tobytes(), v[late].tobytes(),
                             ts[late].tobytes()))
        wm = int(ts.max()) - 1
    got = []
    for c in calls:
        for view in c:
            if view[0] == "late":
                cols = dict((name, raw) for name, _, raw in view[2])
                got.append((cols["k"], cols["v"], view[3]))
    assert got == want and want


def test_async_fire_keeps_the_side_output_in_its_call():
    """The fires of ``async_fire`` surface a call late; each call's side
    output still leaves in that call, right after the fires it drains, and
    equals JAX's (whose CPU dispatch may report a download ready later)."""
    sync, _, _ = _run("port", **LANES["device"])
    got, _, cnt = _run("port", async_fire=True, **LANES["device"])
    want, _, jcnt = _run("jax", async_fire=True, **LANES["device"])
    assert _fires(got) == _fires(sync) == _fires(want)
    late_calls = [[v for v in c if v[0] == "late"] for c in got]
    assert late_calls == [[v for v in c if v[0] == "late"] for c in want]
    assert late_calls == [[v for v in c if v[0] == "late"] for c in sync]
    for c in got:
        kinds = [v[0] for v in c]
        if "late" in kinds:
            # drained fires first, the side output, then this call's
            # re-fires (which surface next call with async_fire)
            i = kinds.index("late")
            assert set(kinds[:i]) <= {"fire"} and kinds.count("late") == 1
    assert cnt["late_dropped"] == jcnt["late_dropped"] == 0


def test_late_tag_snapshot_restores_across_packages():
    """A snapshot taken with the tag restores into the other package's
    operator (``late_dropped`` included), and the rest of the run equals
    the restoring package's own run from the same snapshot."""
    lane = LANES["device"]
    tail = STREAM[4:]
    _, psnap, _ = _run("port", **lane)
    _, jsnap, _ = _run("jax", **lane)
    # port -> JAX
    jop = _mk("jax", **lane)
    with _jax_x64():
        jop.restore_state(snapshot_to_jax(psnap))
        a, _, ja = _drive("jax", jop, tail, snap_at=-1)
    pop = _mk("port", **lane)
    pop.restore_state(psnap)
    b, _, pb = _drive("port", pop, tail, snap_at=-1)
    assert a == b and ja == pb and _late_rows(b) > 0
    # JAX -> port
    pop = _mk("port", **lane)
    pop.restore_state(snapshot_from_jax(jsnap))
    c, _, pc = _drive("port", pop, tail, snap_at=-1)
    assert c == b and pc == pb
    dropped = dict(psnap, late_dropped=7)
    pop = _mk("port", **lane)
    pop.restore_state(snapshot_from_jax(snapshot_to_jax(dropped)))
    assert pop.late_dropped == 7


# ---------------------------------------------------------------------------
# the DataStream route
# ---------------------------------------------------------------------------

def _rows(rows):
    return [{k: (v.item() if isinstance(v, np.generic) else v)
             for k, v in r.items()} for r in rows]


def test_side_output_late_data():
    """``tests/test_datastream.py::test_side_output_late_data`` through
    both packages: beyond-lateness records route to the side output instead
    of being dropped; the main and the side rows equal JAX's."""
    def run(S):
        env = S["env"]()
        tag = S["Tag"]("late")
        ks = np.zeros(12, np.int64)
        vs = np.ones(12)
        ts = np.array([100, 200, 300, 400, 5100, 5200, 5300, 5400,
                       11_000, 12_000, 13_000, 1], np.int64)  # last: LATE
        win = (env.from_collection(columns={"k": ks, "v": vs, "t": ts},
                                   batch_size=4)
               .assign_timestamps_and_watermarks(0, timestamp_column="t")
               .key_by("k")
               .window(S["win"].TumblingEventTimeWindows.of(5000)))
        agg = win.side_output_late_data(tag).sum("v")
        late_sink = agg.get_side_output(tag).collect()
        main_sink = agg.collect()
        env.execute("late-side-output")
        return _rows(main_sink.rows()), _rows(late_sink.rows())
    jmain, jlate = run(SIDES["jax"])
    main, late = run(SIDES["port"])
    assert (main, late) == (jmain, jlate)
    assert len(late) == 1 and late[0]["t"] == 1
    assert sum(r["v"] for r in main) >= 8.0


@pytest.mark.parametrize("route", ["window", "session", "mesh"])
def test_side_output_routes_equal_jax(route):
    """``side_output_late_data`` reaches the window operator, the session
    operator and the mesh operator (the environment's mesh) through the
    API; main and side rows equal JAX's."""
    rng = np.random.default_rng(17)
    n = 3000
    k = rng.integers(0, 50, n).astype(np.int64)
    v = rng.random(n).astype(np.float32)
    t = np.sort(rng.integers(0, 20_000, n)).astype(np.int64)
    t[n // 2: n // 2 + 40] -= 9000           # beyond lateness

    def run(S):
        kw = {}
        if route == "mesh":
            kw["mesh"] = S["mesh"](2)
        env = S["env"](**kw)
        ks = (env.from_collection(columns={"k": k, "v": v, "t": t},
                                  batch_size=500)
              .assign_timestamps_and_watermarks(0, timestamp_column="t")
              .key_by("k"))
        w = (S["win"].EventTimeSessionWindows(300)
             if route == "session"
             else S["win"].TumblingEventTimeWindows.of(1000))
        agg = (ks.window(w).allowed_lateness(500)
               .side_output_late_data(S["Tag"]("late"))
               .aggregate(S["fn"].SumAggregator(S["f32"]), value_column="v"))
        late_sink = agg.get_side_output("late").collect()
        main_sink = agg.collect()
        env.execute()
        return _rows(main_sink.rows()), _rows(late_sink.rows())
    with _jax_x64():
        want = run(SIDES["jax"])
    got = run(SIDES["port"])
    assert got == want
    assert 0 < len(got[1]) <= 40 and got[0]

"""Port parity for session windows: ``flink_tpu_torch.operators.
session_window`` and ``flink_tpu_torch.parallel.mesh_runtime``
``MeshSessionWindowOperator`` against ``flink_tpu``'s on the CPU, on
numpy-seeded batches.

Every case of ``tests/test_session_windows.py`` runs through both packages'
operators in lockstep (:class:`Both`), and every output element is compared
BIT FOR BIT (columns, dtypes, timestamps, side-output tags), as are the
late-drop counters and the snapshots, besides the reference test's own
expectations.  The JAX tests' ``SumAggregator(jnp.float64)`` holds f32
accumulators (x64 is off), so the port's side uses ``float32``.  The two
DataStream cases drive the operators directly: the port has no DataStream
API yet (ROADMAP Queue A item 8).

The mesh cases of ``tests/test_mesh_runtime.py`` run JAX's ``make_mesh(8)``
(the conftest's 8 CPU devices) against the port's ``["cpu"] * 8`` mesh,
bit for bit, with restores at D = 8, 4 and 1 and across packages through
``interop.py``; config 4's workload (``bench.py`` ``run_config4``) at 2^16
records holds the port's mesh to JAX's mesh bit for bit, and the padding
edge cases (fewer rows than blocks, one session, every row on one shard)
hold the mesh to the single operator.
"""

import inspect

import numpy as np
import pytest

import jax.numpy as jnp

from flink_tpu.core import functions as jfn
from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.core.batch import Watermark as JaxWatermark
from flink_tpu.operators.session_window import \
    SessionWindowOperator as JaxSession
from flink_tpu.parallel.mesh import make_mesh as jax_mesh
from flink_tpu.parallel.mesh_runtime import \
    MeshSessionWindowOperator as JaxMeshSession
from flink_tpu.windowing import assigners as jas
from flink_tpu_torch.core import functions as pfn
from flink_tpu_torch.core.batch import RecordBatch, Watermark
from flink_tpu_torch.interop import (session_snapshot_from_jax,
                                     session_snapshot_to_jax)
from flink_tpu_torch.operators.session_window import SessionWindowOperator
from flink_tpu_torch.parallel.mesh import make_mesh
from flink_tpu_torch.parallel.mesh_runtime import MeshSessionWindowOperator
from flink_tpu_torch.windowing import assigners as pas

SIDES = {
    "jax": dict(fn=jfn, Op=JaxSession, Mesh=JaxMeshSession, RB=JaxBatch,
                WM=JaxWatermark, win=jas, f32=jnp.float32,
                mesh=lambda d: jax_mesh(d)),
    "port": dict(fn=pfn, Op=SessionWindowOperator,
                 Mesh=MeshSessionWindowOperator, RB=RecordBatch,
                 WM=Watermark, win=pas, f32="float32",
                 mesh=lambda d: make_mesh(devices=["cpu"] * d)),
}


def _bits(a):
    a = np.asarray(a)
    if a.dtype == object:           # object cells by value, not by address
        return a.dtype.str, a.shape, tuple(a.tolist())
    return a.dtype.str, a.shape, a.tobytes()


def _view(elem):
    """An output element's bits: tag, columns (sorted), timestamps."""
    tag = None
    if not hasattr(elem, "columns"):
        tag, elem = elem.tag, elem.batch
    cols = tuple((c, _bits(elem.column(c))) for c in sorted(elem.columns))
    ts = None if elem.timestamps is None else _bits(elem.timestamps)
    return tag, cols, ts


def _snap_view(x):
    """A snapshot's bits, recursively (dict keys sorted)."""
    if isinstance(x, dict):
        return tuple((k, _snap_view(x[k])) for k in sorted(x))
    if isinstance(x, (list, tuple)):
        return tuple(_snap_view(v) for v in x)
    if isinstance(x, np.ndarray):
        return _bits(x)
    return x


def _agg(side, kind="sum"):
    S = SIDES[side]
    fn = S["fn"]
    return {"sum": lambda: fn.SumAggregator(S["f32"]),
            "avg": lambda: fn.AvgAggregator(S["f32"]),
            "max": lambda: fn.MaxAggregator(S["f32"]),
            "min": lambda: fn.MinAggregator(S["f32"]),
            "count": lambda: fn.CountAggregator(),
            "lambda": lambda: fn.LambdaReduce(lambda a, b: a + b,
                                              np.float32(0.0))}[kind]()


def make_op(side, gap=10, lateness=0, agg="sum", mesh=None, **kw):
    """One package's session operator (JAX's test settings: key "k",
    value "v" into output "v"); ``mesh`` = D for the mesh subclass."""
    S = SIDES[side]
    kw.setdefault("output_column", "v")
    kw.setdefault("value_column", "v")
    args = (S["win"].EventTimeSessionWindows(gap),
            agg(side) if callable(agg) else _agg(side, agg))
    kw = dict(key_column="k", allowed_lateness_ms=lateness, **kw)
    if mesh is not None:
        return S["Mesh"](*args, mesh=S["mesh"](mesh), **kw)
    return S["Op"](*args, **kw)


def S_proc(side, gap=10):
    """A processing-time session operator of one package."""
    S = SIDES[side]
    return S["Op"](S["win"].ProcessingTimeSessionWindows(gap),
                   _agg(side, "sum"), key_column="k", value_column="v",
                   output_column="v")


class Both:
    """One operator per package, driven in lockstep; every call's outputs
    are compared bit for bit as they come."""

    def __init__(self, make, ctx_kw=None):
        self.ops = {}
        for side, S in SIDES.items():
            op = make(side)
            op.open(S["fn"].RuntimeContext(**(ctx_kw or {})))
            self.ops[side] = op
        self.out = []

    @property
    def port(self):
        return self.ops["port"]

    def _both(self, call):
        outs = {side: call(side) for side in SIDES}
        assert [_view(e) for e in outs["jax"]] \
            == [_view(e) for e in outs["port"]]
        self.out += outs["port"]
        return outs["port"]

    def batch(self, keys, vals, ts, extra=None):
        def call(side):
            cols = {"k": np.asarray(keys, np.int64),
                    "v": np.asarray(vals, np.float64)}
            cols.update(extra or {})
            return self.ops[side].process_batch(SIDES[side]["RB"](
                cols, timestamps=np.asarray(ts, np.int64)))
        return self._both(call)

    def wm(self, t):
        return self._both(lambda side: self.ops[side].process_watermark(
            SIDES[side]["WM"](t)))

    def snapshot(self):
        snaps = {side: op.snapshot_state() for side, op in self.ops.items()}
        assert _snap_view(snaps["jax"]) == _snap_view(snaps["port"])
        assert self.ops["jax"].late_dropped == self.port.late_dropped
        return snaps

    def restore(self, snaps):
        for side, op in self.ops.items():
            op.restore_state(snaps[side])

    def clear(self):
        self.out = []

    def fired(self):
        rows = []
        for e in self.out:
            if hasattr(e, "columns"):
                rows += e.to_rows()
        return sorted((int(r["k"]), int(r["window_start"]),
                       int(r["window_end"]), float(r["v"])) for r in rows)


def restored(make, snaps, ctx_kw=None):
    b = Both(make, ctx_kw)
    b.restore(snaps)
    return b


# ---------------------------------------------------------------------------
# the cases of tests/test_session_windows.py
# ---------------------------------------------------------------------------

def test_single_session_fires_after_gap():
    h = Both(lambda s: make_op(s, gap=10))
    h.batch([1, 1, 1], [1, 2, 3], [0, 5, 8])
    h.wm(17)
    assert h.fired() == []
    h.wm(18)
    assert h.fired() == [(1, 0, 18, 6.0)]


def test_gap_splits_sessions():
    h = Both(lambda s: make_op(s, gap=10))
    h.batch([1, 1], [1, 2], [0, 30])
    h.wm(100)
    assert h.fired() == [(1, 0, 10, 1.0), (1, 30, 40, 2.0)]


def test_cross_batch_merge_extends_session():
    h = Both(lambda s: make_op(s, gap=10))
    h.batch([1], [1], [0])
    h.batch([1], [2], [8])
    h.wm(100)
    assert h.fired() == [(1, 0, 18, 3.0)]


def test_bridging_record_merges_two_stored_sessions():
    h = Both(lambda s: make_op(s, gap=10))
    h.batch([1, 1], [1, 2], [0, 18])
    h.batch([1], [10], [9])
    h.wm(100)
    assert h.fired() == [(1, 0, 28, 13.0)]


def test_keys_are_isolated():
    h = Both(lambda s: make_op(s, gap=10))
    h.batch([1, 2], [1, 5], [0, 3])
    h.wm(100)
    assert h.fired() == [(1, 0, 10, 1.0), (2, 3, 13, 5.0)]


def test_late_record_within_lateness_merges_and_refires():
    h = Both(lambda s: make_op(s, gap=10, lateness=100))
    h.batch([1], [1], [0])
    h.wm(50)
    assert h.fired() == [(1, 0, 10, 1.0)]
    h.clear()
    h.batch([1], [2], [5])
    assert h.fired() == [(1, 0, 15, 3.0)]


def test_beyond_lateness_dropped():
    h = Both(lambda s: make_op(s, gap=10, lateness=0))
    h.batch([1], [1], [0])
    h.wm(50)
    h.clear()
    h.batch([1], [2], [5])
    h.wm(100)
    assert h.fired() == []
    assert h.port.late_dropped == h.ops["jax"].late_dropped == 1
    h.snapshot()


@pytest.mark.parametrize("restore_into", ["same", "across"])
def test_snapshot_restore_continues_sessions(restore_into):
    """A snapshot restores into its own package, or (``across``) into the
    other one through ``interop.py``, and continues identically."""
    h = Both(lambda s: make_op(s, gap=10))
    h.batch([1, 2], [1, 2], [0, 3])
    snaps = h.snapshot()
    if restore_into == "across":
        snaps = {"jax": session_snapshot_to_jax(snaps["port"]),
                 "port": session_snapshot_from_jax(snaps["jax"])}
    h2 = restored(lambda s: make_op(s, gap=10), snaps)
    h2.batch([1], [10], [8])
    h2.wm(100)
    assert h2.fired() == [(1, 0, 18, 11.0), (2, 3, 13, 2.0)]


def test_rescale_split_and_merge_roundtrip():
    h = Both(lambda s: make_op(s, gap=10))
    keys = np.arange(50, dtype=np.int64)
    h.batch(keys, np.ones(50), np.zeros(50))
    snaps = h.snapshot()
    parts = {s: SIDES[s]["Op"].split_snapshot(snaps[s], 128, 4)
             for s in SIDES}
    assert _snap_view(parts["jax"]) == _snap_view(parts["port"])
    assert sum(len(p["session_keys"]) for p in parts["port"]) == 50
    seen = []
    for i in range(4):
        hp = restored(lambda s: make_op(s, gap=10),
                      {s: parts[s][i] for s in SIDES})
        hp.wm(100)
        seen.extend(k for k, *_ in hp.fired())
    assert sorted(seen) == list(range(50))
    merged = {s: SIDES[s]["Op"].merge_snapshots(parts[s]) for s in SIDES}
    assert _snap_view(merged["jax"]) == _snap_view(merged["port"])
    hm = restored(lambda s: make_op(s, gap=10), merged)
    hm.wm(100)
    assert len(hm.fired()) == 50


def test_session_multiple_batch_sessions_same_batch_merge_with_store():
    h = Both(lambda s: make_op(s, gap=5))
    h.batch([1], [1], [10])
    h.batch([1, 1], [2, 3], [0, 13])
    h.wm(100)
    assert h.fired() == [(1, 0, 5, 2.0), (1, 10, 18, 4.0)]


def test_session_end_to_end_datastream():
    """The reference's DataStream case, driven at the operator: the port
    has no DataStream API yet (ROADMAP Queue A item 8).  The rows as
    ``from_collection`` batches them, and the watermarks its bounded
    out-of-orderness (0) emits, then the end-of-input watermark."""
    h = Both(lambda s: make_op(s, gap=10))
    h.batch([1, 1, 1, 2], [1.0, 2.0, 4.0, 8.0], [0, 4, 50, 2])
    h.wm(49)
    h.wm(2 ** 63 - 1)
    assert h.fired() == [(1, 0, 14, 3.0), (1, 50, 60, 4.0), (2, 2, 12, 8.0)]


def test_session_avg_nontrivial_acc():
    h = Both(lambda s: make_op(s, gap=10, agg="avg", output_column="result"))
    h.batch([1, 1], [2.0, 4.0], [0, 5])
    out = h.wm(100)
    rows = out[0].to_rows()
    assert len(rows) == 1 and rows[0]["result"] == pytest.approx(3.0)
    assert np.asarray(out[0].column("result")).dtype == np.float32


def test_no_duplicate_emission_after_late_refire():
    h = Both(lambda s: make_op(s, gap=10, lateness=100))
    h.batch([1], [1], [0])
    h.wm(50)
    h.clear()
    h.batch([1], [2], [5])
    assert h.fired() == [(1, 0, 15, 3.0)]
    h.clear()
    h.wm(60)
    assert h.fired() == []


def test_batch_boundary_does_not_change_sessionization():
    h1 = Both(lambda s: make_op(s, gap=100))
    h1.batch([1, 1], [1, 2], [0, 100])
    h1.wm(1000)
    h2 = Both(lambda s: make_op(s, gap=100))
    h2.batch([1], [1], [0])
    h2.batch([1], [2], [100])
    h2.wm(1000)
    assert h1.fired() == h2.fired() == [(1, 0, 100, 1.0), (1, 100, 200, 2.0)]


def test_late_record_overlapping_retained_session_survives():
    h = Both(lambda s: make_op(s, gap=40, lateness=100))
    h.batch([1], [1], [60])
    h.wm(151)
    h.clear()
    h.batch([1], [2], [70])
    h.clear()
    h.batch([1], [4], [10])
    assert h.port.late_dropped == 1
    h3 = Both(lambda s: make_op(s, gap=40, lateness=100))
    h3.batch([1], [1], [60])
    h3.wm(151)
    h3.clear()
    h3.batch([1], [8], [30])
    assert h3.fired() == [(1, 30, 100, 9.0)]
    assert h3.port.late_dropped == 0
    h.snapshot()
    h3.snapshot()


def test_late_record_that_merges_is_not_dropped_even_if_own_window_late():
    h = Both(lambda s: make_op(s, gap=40, lateness=100))
    h.batch([1], [1], [100])
    h.wm(235)
    h.clear()
    h.batch([1], [2], [90])
    assert h.fired() == [(1, 90, 140, 3.0)]
    assert h.port.late_dropped == 0


def test_trigger_on_session_raises():
    """JAX refuses ``.trigger()`` on session windows in its DataStream API
    (sessions fire when the gap closes).  The port has no DataStream API
    yet; at the operator, neither package's session operator takes a
    trigger, and their constructors take the same parameters."""
    from flink_tpu.datastream.api import StreamExecutionEnvironment
    from flink_tpu.windowing.triggers import CountTrigger

    env = StreamExecutionEnvironment()
    with pytest.raises(ValueError, match="session"):
        (env.from_collection([{"k": 1, "v": 1.0}])
         .key_by("k").window(jas.EventTimeSessionWindows(10))
         .trigger(CountTrigger(2)).sum("v"))
    for side in SIDES:
        with pytest.raises(TypeError):
            make_op(side, trigger=object())
    assert list(inspect.signature(JaxSession).parameters) \
        == list(inspect.signature(SessionWindowOperator).parameters)


def test_split_zeroes_counter_in_all_but_first_part():
    h = Both(lambda s: make_op(s, gap=10, lateness=0))
    h.batch([1], [1], [0])
    h.wm(50)
    h.batch([1], [2], [5])
    assert h.port.late_dropped == 1
    snaps = h.snapshot()
    parts = {s: SIDES[s]["Op"].split_snapshot(snaps[s], 128, 4)
             for s in SIDES}
    assert _snap_view(parts["jax"]) == _snap_view(parts["port"])
    assert sum(p.get("late_dropped", 0) for p in parts["port"]) == 1


def test_session_side_output_late_data():
    """The reference's side-output case at the operator (no DataStream API
    in the port yet): ``from_collection(batch_size=2)`` batches, the
    bounded out-of-orderness (0) watermark after each, beyond-lateness
    records as a ``TaggedBatch`` of the tag, the drop counter untouched."""
    h = Both(lambda s: make_op(s, gap=1000, output_column="v",
                               late_output_tag="late-sessions"))
    ks = np.zeros(6, np.int64)
    vs = np.ones(6)
    ts = np.array([100, 300, 20_000, 20_300, 50_000, 10], np.int64)
    top = -2 ** 63
    for lo in range(0, 6, 2):
        h.batch(ks[lo:lo + 2], vs[lo:lo + 2], ts[lo:lo + 2],
                extra={"t": ts[lo:lo + 2]})
        top = max(top, int(ts[lo:lo + 2].max()))
        h.wm(top - 1)
    h.wm(2 ** 63 - 1)
    late = [e for e in h.out if not hasattr(e, "columns")]
    assert len(late) == 1 and late[0].tag == "late-sessions"
    lr = late[0].batch.to_rows()
    assert len(lr) == 1 and lr[0]["t"] == 10
    assert h.port.late_dropped == 0
    assert sum(r["v"] for r in
               (r for e in h.out if hasattr(e, "columns")
                for r in e.to_rows())) >= 4.0


# ---------------------------------------------------------------------------
# beyond the reference file: aggregates, refusals, restores across packages
# ---------------------------------------------------------------------------

def _zipf_session_batches(n_batches=6, batch=512, n_keys=200, seed=5,
                          span=400):
    """``tests/test_mesh_runtime.py``'s session batches."""
    rng = np.random.default_rng(seed)
    t = 0
    out = []
    for _ in range(n_batches):
        keys = np.minimum(rng.zipf(1.6, batch), n_keys).astype(np.int64)
        vals = rng.integers(0, 50, batch).astype(np.float32)
        ts = t + np.sort(rng.integers(0, span, batch)).astype(np.int64)
        t += span
        out.append((keys, vals, ts))
    return out


def _random_value_batches(seed=9, n_batches=5, batch=700, n_keys=60):
    """Random f32 values (sums that round), keys clustered in time so that
    sessions merge across batches and late records arrive."""
    rng = np.random.default_rng(seed)
    out, t = [], 0
    for _ in range(n_batches):
        keys = rng.integers(0, n_keys, batch).astype(np.int64)
        vals = (rng.random(batch) * 10 - 5).astype(np.float32)
        ts = t + np.sort(rng.integers(-400, 300, batch)).astype(np.int64)
        t += 300
        out.append((keys, vals, ts))
    return out


@pytest.mark.parametrize("agg", ["sum", "avg", "max", "min", "count",
                                 "lambda"])
@pytest.mark.parametrize("mesh", [None, 4])
def test_aggregates_bit_for_bit_with_lateness(agg, mesh):
    """Every aggregate kind, the generic combine (the host fold's
    per-segment combine; the mesh takes it too, as JAX's does), late
    records inside and beyond the lateness, re-fires and snapshots, bit for
    bit, single operator and a mesh of 4."""
    h = Both(lambda s: make_op(s, gap=50, lateness=60, agg=agg, mesh=mesh,
                               output_column="result"))
    for keys, vals, ts in _random_value_batches():
        h.batch(keys, vals, ts)
        h.wm(int(ts.max()) - 100)
    h.snapshot()
    h.wm(2 ** 62)
    assert h.out and h.port.late_dropped > 0


def test_distinct_specs_bit_for_bit():
    """DISTINCT aggregates over merging windows: the per-session value
    sets ride the merge, on both packages alike (the aggregate reads its
    column from the whole row, as the SQL planner builds it), single and
    on a mesh of 4 (the distinct column never ships)."""
    specs = {"dc": "COUNT", "ds": "SUM", "da": "AVG", "dmin": "MIN",
             "dmax": "MAX"}

    def agg(side):
        fn = SIDES[side]["fn"]
        return fn.TupleAggregator(
            {"s": ("v", fn.SumAggregator(SIDES[side]["f32"]))})
    for mesh in (None, 4):
        _distinct_case(lambda s: make_op(s, gap=50, agg=agg, mesh=mesh,
                                         distinct_specs=specs,
                                         distinct_column="d",
                                         value_column=None))


def _distinct_case(make):
    h = Both(make)
    rng = np.random.default_rng(3)
    for keys, vals, ts in _random_value_batches(n_batches=3, batch=200):
        h.batch(keys, vals, ts,
                extra={"d": rng.integers(0, 5, keys.size).astype(np.int64)})
        h.wm(int(ts.max()) - 100)
    h.snapshot()
    h.wm(2 ** 62)
    assert h.out


def test_restore_filters_by_key_group_under_parallelism():
    """A restore into subtask 1 of 4 keeps that subtask's key groups only,
    in both packages."""
    h = Both(lambda s: make_op(s, gap=10))
    keys = np.arange(40, dtype=np.int64)
    h.batch(keys, np.ones(40), np.zeros(40))
    snaps = h.snapshot()
    part = restored(lambda s: make_op(s, gap=10), snaps,
                    ctx_kw=dict(parallelism=4, subtask_index=1))
    got = part.snapshot()
    assert 0 < len(got["port"]["session_keys"]) < 40


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshots_cross_packages_mid_run(direction):
    """Zipf sessions: a mid-run snapshot of one package restores into the
    other through ``interop.py``; the restored pair runs bit for bit, and
    its sessions equal an uninterrupted run's."""
    batches = _zipf_session_batches()
    h = Both(lambda s: make_op(s, gap=120, output_column="result"))
    for keys, vals, ts in batches[:3]:
        h.batch(keys, vals, ts)
        h.wm(int(ts.max()) - 1)
    snaps = h.snapshot()
    if direction == "jax_to_port":
        moved = {"port": session_snapshot_from_jax(snaps["jax"]),
                 "jax": snaps["jax"]}
    else:
        moved = {"jax": session_snapshot_to_jax(snaps["port"]),
                 "port": snaps["port"]}
    h2 = restored(lambda s: make_op(s, gap=120, output_column="result"),
                  moved)
    h.clear()
    for keys, vals, ts in batches[3:]:
        h.batch(keys, vals, ts)
        h2.batch(keys, vals, ts)
        h.wm(int(ts.max()) - 1)
        h2.wm(int(ts.max()) - 1)
    # the pair ``h2`` held the port to JAX bit for bit as it ran; against
    # the uninterrupted run the restored key index numbers keys in another
    # order, so compare each session's row, bits included
    def rows(out):
        return sorted((int(r["k"]), int(r["window_start"]),
                       int(r["window_end"]),
                       np.float32(r["result"]).tobytes())
                      for e in out for r in e.to_rows())
    assert rows(h.out) == rows(h2.out) and h.out


def test_processing_time_and_object_keys_raise(monkeypatch):
    """The name is from when both refused.  Processing-time sessions run
    since the local job path's slice: records take the clock seam's time
    (a test clock in both packages), ticks fire and clamp monotone, a
    watermark fires nothing and ``end_input`` fires the rest, bit for bit
    against JAX."""
    from flink_tpu.utils import clock as jclock
    from flink_tpu_torch.utils import clock as pclock
    now = [1_000]
    for c in (jclock, pclock):
        monkeypatch.setattr(c, "now_ms", lambda: now[0])
    h = Both(lambda s: S_proc(s))
    h.batch([1, 2, 1], [1, 2, 3], [0, 0, 0])       # stamped 1000
    now[0] = 1_005
    h.batch([1, 3], [4, 5], [0, 0])                 # no tick yet: 1005
    assert h.wm(1 << 40) == []                      # watermarks fire nothing
    assert h._both(lambda s: h.ops[s].on_processing_time(1_009)) == []
    fired = h._both(lambda s: h.ops[s].on_processing_time(1_010))
    assert len(fired) == 1 and len(fired[0]) == 1   # key 2's session
    h._both(lambda s: h.ops[s].on_processing_time(900))   # clamped
    h.batch([4], [6], [0])                          # the tick's 1010
    h.snapshot()
    assert h._both(lambda s: h.ops[s].end_input())
    assert h.fired() == [(1, 1000, 1015, 8.0), (2, 1000, 1010, 2.0),
                         (3, 1005, 1015, 5.0), (4, 1010, 1020, 6.0)]
    # string keys run since the object-key slice: bit for bit against JAX,
    # on the single operator and on a mesh of 4
    rng = np.random.default_rng(31)
    for mesh in (None, 4):
        h = Both(lambda s: make_op(s, gap=40, mesh=mesh))
        for i in range(4):
            keys = np.char.add("s", rng.integers(0, 30, 300).astype(str))
            ts = (i * 100 + np.sort(rng.integers(0, 100, 300))).astype(
                np.int64)
            vals = rng.random(300)
            h._both(lambda side: h.ops[side].process_batch(
                SIDES[side]["RB"]({"k": keys.astype(object), "v": vals},
                                  timestamps=ts)))
            h.wm(int(ts.max()) - 1)
        h.snapshot()
        assert h.wm(1 << 40) or h.out


# ---------------------------------------------------------------------------
# the mesh cases of tests/test_mesh_runtime.py, and config 4
# ---------------------------------------------------------------------------

def _drive(h, batches):
    for keys, vals, ts in batches:
        h.batch(keys, vals, ts)
        h.wm(int(ts.max()) - 1)


def test_mesh_sessions_zipf_matches_jax_mesh():
    """JAX's ``make_mesh(8)`` against the port's ``["cpu"] * 8``: every
    output bit for bit; the port's mesh also equals the port's single
    operator in (key, start, end) and, to 2 decimals, in sums (the mesh
    folds in row order, ``reduceat`` in its own association)."""
    batches = _zipf_session_batches()
    h = Both(lambda s: make_op(s, gap=120, mesh=8, output_column="result"))
    _drive(h, batches)
    h.wm(1 << 40)
    single = Both(lambda s: make_op(s, gap=120, output_column="result"))
    _drive(single, batches)
    single.wm(1 << 40)

    def rows(out):
        return sorted((int(r["k"]), int(r["window_start"]),
                       int(r["window_end"]), round(float(r["result"]), 2))
                      for e in out for r in e.to_rows())
    assert rows(h.out) == rows(single.out) and len(rows(h.out)) > 50


@pytest.mark.parametrize("restore_devices", [8, 4, 1])
@pytest.mark.parametrize("across", [False, True])
def test_mesh_sessions_checkpoint_restore_rescale(restore_devices, across):
    """A mid-run snapshot of the 8-block mesh restores onto 4 blocks, 8, or
    the single operator (1), in its own package or across, and the tail
    equals JAX's restored tail bit for bit."""
    batches = _zipf_session_batches()
    h = Both(lambda s: make_op(s, gap=120, mesh=8, output_column="result"))
    _drive(h, batches[:3])
    snaps = h.snapshot()
    assert len(snaps["port"]["session_keys"]) > 0
    if across:
        snaps = {"jax": session_snapshot_to_jax(snaps["port"]),
                 "port": session_snapshot_from_jax(snaps["jax"])}
    d = None if restore_devices == 1 else restore_devices
    tail = restored(lambda s: make_op(s, gap=120, mesh=d,
                                      output_column="result"), snaps)
    _drive(tail, batches[3:])
    tail.wm(1 << 40)
    assert tail.out


def _config4_batches(n_records=1 << 16, batch=1 << 13, n_keys=100_000,
                     seed=17):
    """``bench.py`` ``run_config4``'s generator at 2^16 records."""
    rng = np.random.default_rng(seed)
    out, t = [], 0
    for _ in range(n_records // batch):
        keys = ((rng.zipf(1.3, batch) - 1) % n_keys).astype(np.int64)
        vals = rng.random(batch).astype(np.float32)
        ts = t + np.sort(rng.integers(0, 800, batch)).astype(np.int64)
        t += 3000
        out.append((keys, vals, ts))
    return out


@pytest.mark.parametrize("mesh", [4, 8])
def test_config4_smoke_size_mesh_bit_for_bit(mesh):
    """Config 4 (Zipf 1.3 over 100,000 keys, gap 1000 ms, f32 sums) at
    2^16 records: the port's mesh equals JAX's mesh bit for bit, fires and
    the final snapshot."""
    h = Both(lambda s: make_op(s, gap=1000, mesh=mesh,
                               output_column="result"))
    _drive(h, _config4_batches())
    h.snapshot()
    assert sum(len(e) for e in h.out) > 1000


@pytest.mark.parametrize("case", ["fewer_rows_than_blocks", "one_session",
                                  "one_shard"])
def test_mesh_padding_edges(case):
    """Pad rows (``sid = cap_sess``) and unfilled bucket cells must never
    fold: fewer rows than blocks, one session, and every row on one shard
    (keys all ``== 3 mod 8``), held to JAX's mesh bit for bit and to the
    single operator exactly (sums of small integers)."""
    if case == "fewer_rows_than_blocks":
        batches = [(np.array([5, 9, 5], np.int64),
                    np.array([1, 2, 4], np.float32),
                    np.array([0, 3, 7], np.int64))]
    elif case == "one_session":
        batches = [(np.full(40, 11, np.int64), np.arange(40, dtype=np.float32),
                    np.arange(40, dtype=np.int64))]
    else:
        rng = np.random.default_rng(2)
        batches = [(3 + 8 * rng.integers(0, 20, 300).astype(np.int64),
                    rng.integers(0, 9, 300).astype(np.float32),
                    np.sort(rng.integers(0, 500, 300)).astype(np.int64)
                    + 500 * i)
                   for i in range(3)]
    h = Both(lambda s: make_op(s, gap=30, mesh=8, output_column="result"))
    _drive(h, batches)
    h.wm(1 << 40)
    single = Both(lambda s: make_op(s, gap=30, output_column="result"))
    _drive(single, batches)
    single.wm(1 << 40)
    assert [_view(e) for e in h.out] == [_view(e) for e in single.out]
    assert h.out


def test_int64_accumulators_cross_as_jax_holds_them():
    """The port keeps a 64-bit accumulator leaf (``SumAggregator(
    torch.int64)``); JAX with x64 off holds it as int32.  The values agree,
    and ``session_snapshot_to_jax`` narrows the leaf to JAX's dtype, so
    each package restores the other's snapshot and fires the same sums."""
    import torch

    def make(side):
        S = SIDES[side]
        agg = S["fn"].SumAggregator(jnp.int64 if side == "jax"
                                    else torch.int64)
        op = S["Op"](S["win"].EventTimeSessionWindows(50), agg,
                     key_column="k", value_column="v")
        op.open(S["fn"].RuntimeContext())
        return op
    ops = {s: make(s) for s in SIDES}
    batches = _random_value_batches(n_batches=3, batch=300)
    fired = {s: [] for s in SIDES}
    for keys, vals, ts in batches[:2]:
        for s, op in ops.items():
            b = SIDES[s]["RB"]({"k": keys, "v": np.round(vals * 100)
                                .astype(np.int64)}, timestamps=ts)
            fired[s] += op.process_batch(b)
            fired[s] += op.process_watermark(SIDES[s]["WM"](
                int(ts.max()) - 100))
    snaps = {s: op.snapshot_state() for s, op in ops.items()}
    assert snaps["port"]["acc"][0].dtype == np.int64
    assert snaps["jax"]["acc"][0].dtype == np.int32
    to_jax = session_snapshot_to_jax(snaps["port"])
    assert _snap_view(to_jax) == _snap_view(snaps["jax"])
    restored_ops = {"jax": make("jax"), "port": make("port")}
    restored_ops["jax"].restore_state(to_jax)
    restored_ops["port"].restore_state(session_snapshot_from_jax(
        snaps["jax"]))

    def sums(out):
        return sorted((int(r["k"]), int(r["window_start"]),
                       int(r["window_end"]), int(r["result"]))
                      for e in out for r in e.to_rows())
    keys, vals, ts = batches[2]
    tail = {}
    for s, op in restored_ops.items():
        b = SIDES[s]["RB"]({"k": keys, "v": np.round(vals * 100)
                            .astype(np.int64)}, timestamps=ts)
        tail[s] = op.process_batch(b) + op.process_watermark(
            SIDES[s]["WM"](1 << 40))
    assert sums(fired["port"]) == sums(fired["jax"]) and fired["port"]
    assert sums(tail["port"]) == sums(tail["jax"]) and tail["port"]


# ---------------------------------------------------------------------------
# vector accumulator leaves on the mesh
# ---------------------------------------------------------------------------

def _vector_agg(side):
    """An aggregate with non-scalar leaves: per session the 3-vector sum
    ``(v, v*v, 1)`` and the 2-vector min and max of ``(v, -v)``."""
    S = SIDES[side]
    fn = S["fn"]
    xp = jnp if side == "jax" else __import__("torch")
    f32 = jnp.float32 if side == "jax" else xp.float32

    class VectorStats(fn.AggregateFunction):
        def identity(self):
            inf = float("inf")
            return {"s": xp.zeros((3,), dtype=f32),
                    "lo": xp.full((2,), inf, dtype=f32),
                    "hi": xp.full((2,), -inf, dtype=f32)}

        def lift(self, values):
            v = xp.asarray(values, dtype=f32)
            pair = xp.stack([v, -v], 1)
            return {"s": xp.stack([v, v * v, xp.ones_like(v)], 1),
                    "lo": pair, "hi": pair}

        def combine(self, a, b):
            return {"s": a["s"] + b["s"],
                    "lo": xp.minimum(a["lo"], b["lo"]),
                    "hi": xp.maximum(a["hi"], b["hi"])}

        def get_result(self, acc):
            return acc["s"][..., 0] + acc["lo"][..., 0] + acc["hi"][..., 1]

        def scatter_kinds(self):
            return {"s": "add", "lo": "min", "hi": "max"}

    return VectorStats()


@pytest.mark.parametrize("D", [1, 4, 8])
def test_mesh_vector_leaves_bit_for_bit(D):
    """A sum leaf of shape [3] and min/max leaves of shape [2] fold on the
    port's ``["cpu"] * D`` mesh (as ``cap_sess * prod(s)`` flat cells) bit
    for bit against JAX's ``make_mesh(D)``, snapshots included; the
    results also equal the single operator's sessions."""
    batches = _zipf_session_batches(n_batches=5, batch=400, n_keys=90)
    h = Both(lambda s: make_op(s, gap=120, mesh=D, agg=_vector_agg,
                               output_column="result"))
    for i, (keys, vals, ts) in enumerate(batches):
        h.batch(keys, vals, ts)
        h.wm(int(ts.max()) - 1)
        if i == 2:
            h.snapshot()
    h.wm(1 << 40)
    single = Both(lambda s: make_op(s, gap=120, agg=_vector_agg,
                                    output_column="result"))
    _drive(single, batches)
    single.wm(1 << 40)

    def rows(out):
        return sorted((int(r["k"]), int(r["window_start"]),
                       int(r["window_end"])) for e in out for r in e.to_rows())
    assert rows(h.out) == rows(single.out) and len(rows(h.out)) > 30

"""Port parity for the DataStream API's advanced routes: the 28 cases of
``tests/test_streams_advanced.py`` that run without the MiniCluster (the
two ``*_parallel_cluster*`` cases wait for the cluster runtime, ROADMAP
Queue A item 8.4), through both packages on the same numpy inputs.

Connected streams (``CoMapOperator``, ``BroadcastConnectOperator``), the
window and interval joins (``WindowJoinOperator``, ``IntervalJoinOperator``),
side outputs of a process function, async I/O (``AsyncWaitOperator``:
ordered, unordered behind the watermark fence, the timeout replacement and
the fenced watermark in the snapshot), the host evicting lane
(``EvictingWindowOperator``: any evictor, ``DeltaEvictor`` through the rows
protocol, late re-fires, panes shared across sliding windows, split/merge by
key group), streaming iterations and the watermark valve's idleness.  Each
case runs as a scenario through each package (:func:`both`): what the port
returns must equal JAX's, in order unless the reference test itself sorts
(threads and unordered async emission), and the reference test's own
expectation is asserted on the port's result.  The port's environment runs
on ``device="cpu"``.  The snapshots of the async and the evicting operator
restore across packages both ways.
"""

import time

import numpy as np
import pytest

from flink_tpu import datastream as jds
from flink_tpu import windowing as jwin
from flink_tpu.core import batch as jbatch
from flink_tpu.core import functions as jfn
from flink_tpu.operators import async_io as jasync
from flink_tpu.operators import co as jco
from flink_tpu.operators import evicting_window as jev
from flink_tpu.operators import joins as jjoins
from flink_tpu.operators import process as jprocess
from flink_tpu.operators import window_agg as jwa
from flink_tpu.runtime import executor as jexec
from flink_tpu.windowing import evictors as jevictors
from flink_tpu_torch import datastream as pds
from flink_tpu_torch import windowing as pwin
from flink_tpu_torch.core import batch as pbatch
from flink_tpu_torch.core import functions as pfn
from flink_tpu_torch.operators import async_io as pasync
from flink_tpu_torch.operators import co as pco
from flink_tpu_torch.operators import evicting_window as pev
from flink_tpu_torch.operators import joins as pjoins
from flink_tpu_torch.operators import process as pprocess
from flink_tpu_torch.operators import window_agg as pwa
from flink_tpu_torch.runtime import executor as pexec
from flink_tpu_torch.windowing import evictors as pevictors
from test_torch_calibration import verdicts  # noqa: F401 — the fixture

SIDES = {
    "jax": dict(env=lambda **kw: jds.StreamExecutionEnvironment(**kw),
                win=jwin, batch=jbatch, fn=jfn, aio=jasync, co=jco, ev=jev,
                joins=jjoins, process=jprocess, wa=jwa, exec=jexec,
                evictors=jevictors),
    "port": dict(env=lambda **kw: pds.StreamExecutionEnvironment(
                     device="cpu", **kw),
                 win=pwin, batch=pbatch, fn=pfn, aio=pasync, co=pco, ev=pev,
                 joins=pjoins, process=pprocess, wa=pwa, exec=pexec,
                 evictors=pevictors),
}


@pytest.fixture(autouse=True)
def _pinned(verdicts):  # noqa: F811 — the fixture
    verdicts(taxed=False, shards=1, super_shards=1, depth=1, probe=False)


def _plain(v):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    return v


def both(scenario, *args):
    """``scenario(S, *args)`` through each package; the results must be
    equal.  Returns the port's."""
    want = _plain(scenario(SIDES["jax"], *args))
    got = _plain(scenario(SIDES["port"], *args))
    assert got == want
    return got


def _rows(out):
    """The rows of the record batches among an operator's outputs."""
    return [r for b in out if hasattr(b, "columns") for r in b.to_rows()]


def _open(S, op):
    op.open(S["fn"].RuntimeContext())
    return op


# ---------------------------------------------------------------------------
# connected streams and broadcast state
# ---------------------------------------------------------------------------

def test_connect_co_map():
    def run(S):
        env = S["env"]()
        a = env.from_collection(columns={"x": np.arange(5, dtype=np.int64)})
        b = env.from_collection(columns={"x": np.arange(5, dtype=np.int64)})
        return (a.connect(b)
                .map(lambda c: {"y": np.asarray(c["x"]) * 10},
                     lambda c: {"y": np.asarray(c["x"]) * 100})
                .execute_and_collect())
    out = both(run)
    ys = sorted(r["y"] for r in out)
    assert ys == sorted([x * 10 for x in range(5)]
                        + [x * 100 for x in range(5)])


def _rules(S):
    class Rules(S["co"].BroadcastProcessFunction):
        def process_broadcast_batch(self, cols, state, ctx):
            for k, v in zip(np.asarray(cols["key"]).tolist(),
                            np.asarray(cols["mult"]).tolist()):
                state[int(k)] = v

        def process_batch(self, cols, state, ctx):
            x = np.asarray(cols["k"])
            mult = np.asarray([state.get(int(k), 0) for k in x])
            return {"k": x, "scaled": np.asarray(cols["v"]) * mult}
    return Rules()


def test_broadcast_state_pattern():
    def run(S):
        env = S["env"]()
        rules = env.from_collection(columns={"key": np.array([0, 1]),
                                             "mult": np.array([10.0, 100.0])})
        main = env.from_collection(columns={"k": np.array([0, 1, 0]),
                                            "v": np.array([1.0, 2.0, 3.0])})
        return main.connect_broadcast(rules, _rules(S)).execute_and_collect()
    out = both(run)
    assert sorted(r["scaled"] for r in out) == [10.0, 30.0, 200.0]


def test_broadcast_connect_row_filtering_keeps_working():
    """A broadcast function that changes the row count does not crash on
    the timestamps' re-attachment."""
    def run(S):
        class Allow(S["co"].BroadcastProcessFunction):
            def process_broadcast_batch(self, cols, state, ctx):
                state["allowed"] = set(np.asarray(cols["k"]).tolist())

            def process_batch(self, cols, state, ctx):
                k = np.asarray(cols["k"])
                keep = np.isin(k, list(state.get("allowed", ())))
                return {"k": k[keep]}

        env = S["env"]()
        rules = env.from_collection(columns={"k": np.array([2])})
        main = (env.from_collection(columns={"k": np.array([1, 2, 3]),
                                             "t": np.array([10, 20, 30])})
                .assign_timestamps_and_watermarks(0, timestamp_column="t"))
        return main.connect_broadcast(rules, Allow()).execute_and_collect()
    assert [r["k"] for r in both(run)] == [2]


def test_co_flat_map_and_co_process_operators():
    """``CoFlatMapOperator`` and ``CoProcessOperator`` (with its watermark
    hook) and the broadcast state's snapshot, on each input."""
    def run(S):
        RB, WM = S["batch"].RecordBatch, S["batch"].Watermark
        fm = _open(S, S["co"].CoFlatMapOperator(
            lambda c: {"x": np.repeat(np.asarray(c["x"]), 2)},
            lambda c: None))
        b = RB({"x": np.array([1, 2])}, timestamps=np.array([5, 6]))
        out = [_rows(fm.process_batch2(b, 0)), fm.process_batch2(b, 1),
               _rows(fm.process_batch(b))]

        class Fn(S["co"].CoProcessFunction):
            def process_batch1(self, cols, ctx):
                return {"side": np.zeros(len(cols["x"]), np.int64)}

            def process_batch2(self, cols, ctx):
                return {"side": np.ones(len(cols["x"]), np.int64)}

            def on_watermark(self, ts, ctx):
                return {"wm": np.array([ts])}

        cp = _open(S, S["co"].CoProcessOperator(Fn()))
        out += [_rows(cp.process_batch2(b, 0)), _rows(cp.process_batch2(b, 1)),
                _rows(cp.process_watermark(WM(77)))]
        bc = _open(S, S["co"].BroadcastConnectOperator(_rules(S)))
        bc.process_batch2(RB({"key": np.array([3]),
                              "mult": np.array([2.0])}), 1)
        snap = bc.snapshot_state()
        bc2 = _open(S, S["co"].BroadcastConnectOperator(_rules(S)))
        bc2.restore_state(snap)
        out += [snap, _rows(bc2.process_batch2(
            RB({"k": np.array([3]), "v": np.array([4.0])}), 0))]
        return out
    out = both(run)
    assert out[0] == [{"x": 1}, {"x": 1}, {"x": 2}, {"x": 2}]
    assert out[-1] == [{"k": 3, "scaled": 8.0}]


# ---------------------------------------------------------------------------
# the joins
# ---------------------------------------------------------------------------

def test_interval_join():
    def run(S):
        env = S["env"]()
        left = (env.from_collection(columns={"k": np.array([1, 1, 2]),
                                             "lv": np.array([10., 20., 30.]),
                                             "t": np.array([100, 200, 100])})
                .assign_timestamps_and_watermarks(0, timestamp_column="t")
                .key_by("k"))
        right = (env.from_collection(columns={"k": np.array([1, 1, 2]),
                                              "rv": np.array([1., 2., 3.]),
                                              "t": np.array([105, 350, 190])})
                 .assign_timestamps_and_watermarks(0, timestamp_column="t")
                 .key_by("k"))
        return (left.interval_join(right).between(-50, 50).process()
                .execute_and_collect())
    pairs = sorted((r["lv"], r["rv"]) for r in both(run))
    assert pairs == [(10.0, 1.0)]


def test_window_join():
    def run(S):
        env = S["env"]()
        left = (env.from_collection(columns={"k": np.array([1, 1, 2]),
                                             "lv": np.array([1., 2., 3.]),
                                             "t": np.array([10, 150, 20])})
                .assign_timestamps_and_watermarks(0, timestamp_column="t"))
        right = (env.from_collection(columns={"k": np.array([1, 2, 2]),
                                              "rv": np.array([5., 6., 7.]),
                                              "t": np.array([40, 30, 160])})
                 .assign_timestamps_and_watermarks(0, timestamp_column="t"))
        return (left.join(right).where("k").equal_to("k")
                .window(S["win"].TumblingEventTimeWindows.of(100))
                .apply().execute_and_collect())
    out = both(run)
    assert sorted((r["lv"], r["rv"]) for r in out) == [(1.0, 5.0),
                                                        (3.0, 6.0)]
    assert all(r["window_end"] % 100 == 0 for r in out)


def test_window_cogroup_fires_one_sided():
    def run(S):
        env = S["env"]()
        left = (env.from_collection(columns={"k": np.array([1]),
                                             "lv": np.array([1.]),
                                             "t": np.array([10])})
                .assign_timestamps_and_watermarks(0, timestamp_column="t"))
        right = (env.from_collection(columns={"k": np.array([2]),
                                              "rv": np.array([5.]),
                                              "t": np.array([20])})
                 .assign_timestamps_and_watermarks(0, timestamp_column="t"))

        def fold(key, window, lrows, rrows):
            return {"k": key, "nl": len(lrows), "nr": len(rrows)}

        return (left.co_group(right).where("k").equal_to("k")
                .window(S["win"].TumblingEventTimeWindows.of(100))
                .apply(fold).execute_and_collect())
    got = {r["k"]: (r["nl"], r["nr"]) for r in both(run)}
    assert got == {1: (1, 0), 2: (0, 1)}


def test_cogroup_without_fn_raises_eagerly():
    for S in SIDES.values():
        env = S["env"]()
        a = env.from_collection(columns={"k": np.array([1]),
                                         "t": np.array([1])})
        b = env.from_collection(columns={"k": np.array([1]),
                                         "t": np.array([1])})
        with pytest.raises(ValueError, match="co_group"):
            (a.co_group(b).where("k").equal_to("k")
             .window(S["win"].TumblingEventTimeWindows.of(10)).apply())
        with pytest.raises(ValueError, match="where"):
            a.join(b).window(S["win"].TumblingEventTimeWindows.of(10)).apply()


def test_interval_join_intermediate_watermark_keeps_right_rows():
    """A watermark between a matching pair must not evict the right row
    before the left row fires."""
    def run(S):
        RB, WM = S["batch"].RecordBatch, S["batch"].Watermark
        op = _open(S, S["joins"].IntervalJoinOperator("k", "k", 0, 10))
        op.process_batch2(RB({"k": np.array([1]), "lv": np.array([1.0])},
                             timestamps=np.array([95])), 0)
        op.process_batch2(RB({"k": np.array([1]), "rv": np.array([2.0])},
                             timestamps=np.array([96])), 1)
        out = op.process_watermark(WM(100))   # left not yet complete
        out += op.process_watermark(WM(110))  # now it fires
        return [(r["lv"], r["rv"]) for r in _rows(out)]
    assert both(run) == [(1.0, 2.0)]


# ---------------------------------------------------------------------------
# side outputs
# ---------------------------------------------------------------------------

def test_side_outputs():
    def run(S):
        tag = S["batch"].OutputTag("big")

        class Splitter(S["process"].KeyedProcessFunction):
            def process_batch(self, ctx, batch):
                v = np.asarray(batch.column("v"))
                big = v >= 10
                if big.any():
                    ctx.side_output(tag, {"v": v[big]})
                return [batch.select(~big)]

        env = S["env"]()
        main = (env.from_collection(
            columns={"k": np.zeros(6, np.int64),
                     "v": np.array([1., 20., 2., 30., 3., 4.])})
            .key_by("k").process(Splitter()))
        main_sink = main.collect()
        side_sink = main.get_side_output(tag).collect()
        env.execute()
        return main_sink.rows(), side_sink.rows()
    main, side = both(run)
    assert sorted(r["v"] for r in main) == [1., 2., 3., 4.]
    assert sorted(r["v"] for r in side) == [20., 30.]


# ---------------------------------------------------------------------------
# async I/O
# ---------------------------------------------------------------------------

def test_async_io_ordered():
    def run(S):
        env = S["env"]()
        calls = []

        def lookup(cols):
            calls.append(len(cols["x"]))
            return {"x": cols["x"], "y": np.asarray(cols["x"]) * 2}

        out = (env.from_collection(
            columns={"x": np.arange(100, dtype=np.int64)}, batch_size=10)
            .async_wait(lookup, capacity=4, ordered=True)
            .execute_and_collect())
        return out, len(calls)
    out, calls = both(run)
    assert [r["x"] for r in out] == list(range(100))
    assert all(r["y"] == r["x"] * 2 for r in out) and calls == 10


def _kinds(out):
    return [(type(e).__name__, (np.asarray(e.column("x"))[0]
                                if hasattr(e, "columns") else e.timestamp))
            for e in out]


def test_async_io_unordered_with_watermark_fence():
    def run(S):
        RB, WM = S["batch"].RecordBatch, S["batch"].Watermark

        def slow_first(cols):
            if cols["x"][0] == 0:
                time.sleep(0.05)
            return {"x": cols["x"]}

        op = _open(S, S["aio"].AsyncWaitOperator(slow_first, capacity=8,
                                                 ordered=False))
        out = []
        out += op.process_batch(RB({"x": np.array([0])}))
        out += op.process_batch(RB({"x": np.array([1])}))
        out += op.process_watermark(WM(100))
        out += op.process_batch(RB({"x": np.array([2])}))
        out += op.end_input()
        op.close()
        kinds = _kinds(out)
        xs = [v for k, v in kinds if k == "RecordBatch"]
        wm_pos = [i for i, (k, _) in enumerate(kinds)
                  if k == "Watermark"][0]
        # the emission order before the fence is the threads' own
        return sorted(xs[:wm_pos]), xs[wm_pos:], [k for k in kinds
                                                  if k[0] == "Watermark"]
    before, after, wms = both(run)
    assert before == [0, 1] and after == [2] and wms == [("Watermark", 100)]


class _Slow:
    """An async function that outlives its timeout."""

    @staticmethod
    def make(S):
        class Slow(S["aio"].AsyncFunction):
            def invoke(self, cols):
                time.sleep(1.0)
                return cols

            def timeout(self, cols):
                return {"x": cols["x"],
                        "timed_out": np.ones(len(cols["x"]), bool)}
        return Slow()


@pytest.mark.parametrize("ordered", [True, False],
                         ids=["ordered", "unordered"])
def test_async_io_timeout_replacement(ordered):
    def run(S):
        op = _open(S, S["aio"].AsyncWaitOperator(
            _Slow.make(S), timeout_ms=30, ordered=ordered))
        out = op.process_batch(S["batch"].RecordBatch({"x": np.array([7])}))
        out += op.end_input()
        op.close()
        return _rows(out)
    assert both(run) == [{"x": 7, "timed_out": True}]


def test_async_unordered_timeout_replacement():
    def run(S):
        op = _open(S, S["aio"].AsyncWaitOperator(
            _Slow.make(S), timeout_ms=30, ordered=False))
        out = op.process_batch(S["batch"].RecordBatch({"x": np.array([7])}))
        out += op.end_input()
        op.close()
        return any(hasattr(e, "columns") and "timed_out" in e.columns
                   for e in out)
    assert both(run) is True


def test_async_does_not_forward_watermarks_early():
    for S in SIDES.values():
        assert S["aio"].AsyncWaitOperator(lambda c: c).forwards_watermarks \
            is False


def _fenced_snapshot(S):
    """An async operator's snapshot with a batch in flight and a watermark
    queued behind it."""
    def slow(cols):
        time.sleep(0.2)
        return cols

    op = _open(S, S["aio"].AsyncWaitOperator(slow, ordered=True))
    op.process_batch(S["batch"].RecordBatch({"x": np.array([1])},
                                            timestamps=np.array([5])))
    op.process_watermark(S["batch"].Watermark(50))
    snap = op.snapshot_state()
    op.close()
    return snap


def _finish_async(S, snap):
    op = _open(S, S["aio"].AsyncWaitOperator(lambda c: c, ordered=True))
    op.restore_state(snap)
    out = op.end_input()
    op.close()
    return [("wm", e.timestamp) if not hasattr(e, "columns")
            else ("rows", e.to_rows(), np.asarray(e.timestamps).tolist())
            for e in out]


def test_async_snapshot_preserves_fenced_watermark():
    """A watermark queued behind in-flight work survives a checkpoint (the
    operator is its only forwarder)."""
    out = both(lambda S: _finish_async(S, _fenced_snapshot(S)))
    assert ("wm", 50) in out and any(e[0] == "rows" for e in out)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_async_snapshot_restores_across_packages(writer):
    reader = "port" if writer == "jax" else "jax"
    snap = _fenced_snapshot(SIDES[writer])
    assert _plain(_finish_async(SIDES[reader], snap)) == \
        _plain(_finish_async(SIDES[writer], snap))
    assert _queue_view(snap) == _queue_view(_fenced_snapshot(SIDES[reader]))


def _queue_view(snap):
    return [("wm", e["watermark"]) if "watermark" in e else
            ("batch", {c: np.asarray(v).tobytes()
                       for c, v in e["columns"].items()},
             np.asarray(e["timestamps"]).tobytes())
            for e in snap["queue"]]


# ---------------------------------------------------------------------------
# the host evicting lane
# ---------------------------------------------------------------------------

def _apply_job(S, evictor, cols, fn, window=100):
    env = S["env"]()
    w = (env.from_collection(columns=cols)
         .assign_timestamps_and_watermarks(0, timestamp_column="t")
         .key_by("k")
         .window(S["win"].TumblingEventTimeWindows.of(window)))
    if evictor is not None:
        w = w.evictor(evictor(S))
    return w.apply(fn).execute_and_collect()


def test_evicting_window_count_evictor():
    cols = {"k": np.zeros(6, np.int64),
            "v": np.array([1., 2., 3., 4., 5., 6.]),
            "t": np.array([10, 20, 30, 40, 50, 60])}
    out = both(lambda S: _apply_job(
        S, lambda S: S["evictors"].CountEvictor.of(2), cols,
        lambda k, w, rows: {"k": k, "s": sum(r["v"] for r in rows)}))
    assert [r["s"] for r in out] == [11.0]


def test_window_apply_without_evictor():
    cols = {"k": np.array([1, 1, 2]), "v": np.array([1., 2., 5.]),
            "t": np.array([10, 20, 30])}
    out = both(lambda S: _apply_job(
        S, None, cols,
        lambda k, w, rows: {"k": k, "n": len(rows), "start": w.start}))
    assert {r["k"]: r["n"] for r in out} == {1: 2, 2: 1}
    assert all(r["start"] == 0 for r in out)


def test_time_evictor():
    cols = {"k": np.zeros(4, np.int64), "v": np.array([1., 2., 4., 8.]),
            "t": np.array([0, 50, 80, 90])}
    out = both(lambda S: _apply_job(
        S, lambda S: S["evictors"].TimeEvictor.of(15), cols,
        lambda k, w, rows: {"s": sum(r["v"] for r in rows)}))
    assert [r["s"] for r in out] == [12.0]


def test_delta_evictor_via_rows_protocol():
    cols = {"k": np.zeros(4, np.int64), "v": np.array([1., 9., 10., 11.]),
            "t": np.array([10, 20, 30, 40])}
    out = both(lambda S: _apply_job(
        S, lambda S: S["evictors"].DeltaEvictor.of(2.0, "v"), cols,
        lambda k, w, rows: {"s": sum(r["v"] for r in rows)}))
    assert [r["s"] for r in out] == [30.0]


def test_evicting_window_allowed_lateness_refire():
    def run(S):
        RB, WM = S["batch"].RecordBatch, S["batch"].Watermark
        op = _open(S, S["ev"].EvictingWindowOperator(
            S["win"].TumblingEventTimeWindows.of(100), None, "k",
            lambda k, w, rows: {"n": len(rows)}, allowed_lateness_ms=50))
        seen = []
        op.process_batch(RB({"k": np.array([1])}, timestamps=np.array([10])))
        seen.append([r["n"] for r in _rows(op.process_watermark(WM(100)))])
        # late element within lateness: the window re-fires
        seen.append([r["n"] for r in _rows(op.process_batch(
            RB({"k": np.array([1])}, timestamps=np.array([20]))))])
        # beyond lateness: dropped silently
        op.process_watermark(WM(200))
        seen.append(op.process_batch(RB({"k": np.array([1])},
                                        timestamps=np.array([30]))))
        return seen
    assert both(run) == [[1], [2], []]


def test_evicting_sliding_windows_share_pane_buffers():
    """Sliding assigners on the raw-element lane: each row is buffered once
    a pane yet appears in every covering window's apply()."""
    def run(S):
        RB, WM = S["batch"].RecordBatch, S["batch"].Watermark
        op = _open(S, S["ev"].EvictingWindowOperator(
            S["win"].SlidingEventTimeWindows.of(100, 50), None, "k",
            lambda k, w, rows: {"k": k, "n": len(rows), "ws": w.start,
                                "s": sum(r["v"] for r in rows)}))
        out = op.process_batch(RB(
            {"k": np.array([1, 1, 1]), "v": np.array([1.0, 2.0, 4.0])},
            timestamps=np.array([10, 60, 110])))
        buffered = sum(c[0].size for chunks in op._panes.values()
                       for c in chunks)
        out += op.process_watermark(WM(250))
        return sorted((int(r["ws"]), int(r["n"]), float(r["s"]))
                      for r in _rows(out)), buffered
    rows, buffered = both(run)
    assert rows == [(-50, 1, 1.0), (0, 2, 3.0), (50, 2, 6.0), (100, 1, 4.0)]
    assert buffered <= 3


def test_evicting_window_late_refire_and_beyond_lateness_drop():
    def run(S):
        RB, WM = S["batch"].RecordBatch, S["batch"].Watermark
        op = _open(S, S["ev"].EvictingWindowOperator(
            S["win"].TumblingEventTimeWindows.of(100), None, "k",
            lambda k, w, rows: {"k": k, "s": sum(r["v"] for r in rows)},
            allowed_lateness_ms=100))
        seen = []
        op.process_batch(RB({"k": np.array([1]), "v": np.array([5.0])},
                            timestamps=np.array([10])))
        seen.append([r["s"] for r in _rows(op.process_watermark(WM(120)))])
        seen.append([r["s"] for r in _rows(op.process_batch(
            RB({"k": np.array([1]), "v": np.array([2.0])},
               timestamps=np.array([50]))))])
        op.process_watermark(WM(250))
        op.process_batch(RB({"k": np.array([1]), "v": np.array([9.0])},
                            timestamps=np.array([20])))
        return seen, op.late_dropped
    seen, dropped = both(run)
    assert seen == [[5.0], [7.0]] and dropped == 1


def _evicting(S):
    return _open(S, S["ev"].EvictingWindowOperator(
        S["win"].TumblingEventTimeWindows.of(100), None, "k",
        lambda k, w, rows: {"k": k, "s": sum(r["v"] for r in rows)}))


def _evicting_snapshot(S):
    op = _evicting(S)
    op.process_batch(S["batch"].RecordBatch(
        {"k": np.arange(20), "v": np.ones(20)}, timestamps=np.full(20, 10)))
    return op.snapshot_state()


def _finish_evicting(S, snap):
    op = _evicting(S)
    op.restore_state(snap)
    out = op.process_watermark(S["batch"].Watermark(150))
    return sorted(int(r["k"]) for r in _rows(out))


def test_evicting_window_snapshot_restore_and_keygroup_rescale():
    def run(S):
        snap = _evicting_snapshot(S)
        plain = _finish_evicting(S, snap)
        parts = S["ev"].EvictingWindowOperator.split_snapshot(snap, 128, 4)
        total = sum(p0["seq"].size for part in parts
                    for p0 in part["panes"].values())
        merged = S["ev"].EvictingWindowOperator.merge_snapshots(parts)
        return plain, total, _finish_evicting(S, merged), [
            sorted(int(k) for p in part["panes"].values()
                   for k in p["cols"]["k"]) for part in parts]
    plain, total, rescaled, parts = both(run)
    assert plain == rescaled == list(range(20)) and total == 20
    assert sorted(k for p in parts for k in p) == list(range(20))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_evicting_snapshot_restores_across_packages(writer):
    reader = "port" if writer == "jax" else "jax"
    snap = _evicting_snapshot(SIDES[writer])
    assert _finish_evicting(SIDES[reader], snap) == list(range(20))
    other = _evicting_snapshot(SIDES[reader])
    assert _plain({k: v for k, v in snap.items() if k != "panes"}) == \
        _plain({k: v for k, v in other.items() if k != "panes"})
    for p, packed in snap["panes"].items():
        o = other["panes"][p]
        assert packed["seq"].tobytes() == o["seq"].tobytes()
        assert packed["ts"].tobytes() == o["ts"].tobytes()
        assert {c: v.tobytes() for c, v in packed["cols"].items()} == \
            {c: v.tobytes() for c, v in o["cols"].items()}


# ---------------------------------------------------------------------------
# streaming iterations
# ---------------------------------------------------------------------------

def test_streaming_iteration():
    """Collatz-ish loop: halve evens, feed odds*3+1 back until all reach 1."""
    def run(S):
        env = S["env"]()
        start = env.from_collection(columns={"x": np.array([5, 6, 7],
                                                           np.int64)})
        it = start.iterate(max_wait_ms=300)

        def step(cols):
            x = np.asarray(cols["x"])
            return {"x": np.where(x % 2 == 0, x // 2, 3 * x + 1)}

        body = it.map(step)
        not_done = body.filter(lambda c: np.asarray(c["x"]) != 1)
        done = body.filter(lambda c: np.asarray(c["x"]) == 1)
        it.close_with(not_done)
        sink = done.collect()
        env.execute()
        return sorted(r["x"] for r in sink.rows())
    assert both(run) == [1, 1, 1]


# ---------------------------------------------------------------------------
# watermark idleness (StreamStatus / StatusWatermarkValve.markIdle analog)
# ---------------------------------------------------------------------------

def test_valve_idle_channel_excluded():
    def run(S):
        LONG_MIN = S["batch"].LONG_MIN
        v = S["exec"].WatermarkValve(2)
        seen = [v.input_watermark(0, 100)]       # ch1 still at LONG_MIN
        seen.append(v.input_status(1, True))     # ch1 idle -> min is 100
        seen.append(v.input_watermark(0, 200))   # advances on ch0 alone
        seen.append(v.input_status(1, False))    # back, behind: no regress
        seen.append(v.input_watermark(1, 150))
        seen.append(v.input_watermark(1, 300))
        seen.append(v.input_watermark(0, 400))
        v2 = S["exec"].WatermarkValve(2)
        v2.input_status(0, True)
        seen.append(v2.input_status(1, True))    # all idle: nothing proven
        return seen, LONG_MIN
    seen, _ = both(run)
    assert seen == [None, 100, 200, None, None, None, 300, None]


def test_idle_input_does_not_stall_windows():
    """A silent second input marked idle does not freeze event time: the
    window fires from the active input's watermarks alone (the reference
    case drives a cluster subtask; here the local runtime's valve feeds the
    window operator)."""
    def run(S):
        RB = S["batch"].RecordBatch
        valve = S["exec"].WatermarkValve(2)
        kw = {"device": "cpu"} if S is SIDES["port"] else {}
        op = _open(S, S["wa"].WindowAggOperator(
            S["win"].TumblingEventTimeWindows.of(1000),
            S["fn"].SumAggregator(), key_column="k", value_column="v", **kw))
        out = op.process_batch(RB({"k": np.array([1, 1]),
                                   "v": np.array([2., 3.], np.float32)},
                                  timestamps=np.array([10, 20], np.int64)))
        fired = []
        for step in (lambda: valve.input_watermark(0, 2000),
                     lambda: valve.input_status(1, True)):
            wm = step()
            if wm is not None:
                fired += _rows(op.process_watermark(S["batch"].Watermark(wm)))
        return _rows(out), fired
    none, fired = both(run)
    assert none == [] and fired and fired[0]["result"] == 5.0


def test_valve_idle_survives_snapshot_restore():
    """A checkpoint taken while a channel is idle restores WITH the idle
    flag; a legacy list-only snapshot restores too."""
    def run(S):
        V = S["exec"].WatermarkValve
        v = V(2)
        v.input_watermark(0, 1000)
        v.input_status(1, True)
        snap = v.snapshot()
        v2 = V(2)
        v2.restore(snap)
        v3 = V(2)
        v3.restore([500, 700])
        return (v.current, v2.current, list(v2.idle),
                v2.input_watermark(0, 2000), v3.current, snap)
    assert both(run)[:5] == (1000, 1000, [False, True], 2000, 500)


def test_valve_idle_refoward_after_reactivation():
    """A watermark reactivating an all-idle valve resets the combined
    status, so the next all-idle transition forwards again."""
    def run(S):
        v = S["exec"].WatermarkValve(2)
        v.status_update(0, True)
        first = v.status_update(1, True)[1:]
        v.input_watermark(0, 100)
        return first, v.status_update(0, True)[1:]
    assert both(run) == ((True, True), (True, True))

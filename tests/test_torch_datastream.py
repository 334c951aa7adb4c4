"""Port parity for the DataStream API and the local job path:
``flink_tpu_torch.datastream`` on ``LocalExecutor`` against
``flink_tpu.datastream`` on the CPU.

Every case of ``tests/test_datastream.py`` but ``test_side_output_late_
data`` (it is in ``tests/test_torch_late_output.py``) runs as a scenario through both packages' environments on the same numpy inputs
(:func:`both`): the collected rows must be equal, in order, and the
reference test's own expectation is asserted on the port's rows.  The port's
environment runs its device operators on ``device="cpu"``.  The API's
``sum``/``min``/``max`` default to ``torch.float64`` where JAX's ask for
``jnp.float64`` (which JAX without x64 holds as f32): the values compared
here are exact in both.

Also here: the verify skill's canonical flow with string keys, processing-
time windows through the clock seam (a test clock, so windows fall where the
test puts them), the route of the JAX API that a later slice brings (it
raises and names its item), the keyed-process route over the configured
backend, periodic checkpoints into any ``store(id, snapshot)`` object, and
the socket source on a loopback server.
"""

import socket
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_tpu import datastream as jds
from flink_tpu import windowing as jwin
from flink_tpu.config.config_option import Configuration as JaxConfiguration
from flink_tpu.config.options import StateOptions as JaxStateOptions
from flink_tpu.connectors import sinks as jsinks
from flink_tpu.connectors import sources as jsources
from flink_tpu.core import functions as jfn
from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.operators import process as jprocess
from flink_tpu.state import api as japi
from flink_tpu.utils import clock as jclock
from flink_tpu_torch import datastream as pds
from flink_tpu_torch import windowing as pwin
from flink_tpu_torch.config.config_option import Configuration
from flink_tpu_torch.config.options import StateOptions
from flink_tpu_torch.connectors import sinks as psinks
from flink_tpu_torch.connectors import sources as psources
from flink_tpu_torch.core import functions as pfn
from flink_tpu_torch.core.batch import RecordBatch
from flink_tpu_torch.operators import process as pprocess
from flink_tpu_torch.state import api as papi
from flink_tpu_torch.utils import clock as pclock
from test_torch_calibration import verdicts  # noqa: F401 — the fixture

SIDES = {
    "jax": dict(env=lambda **kw: jds.StreamExecutionEnvironment(**kw),
                win=jwin, sinks=jsinks, sources=jsources, fn=jfn,
                f32=jnp.float32, clock=jclock, process=jprocess,
                state_api=japi, RB=JaxBatch,
                Config=JaxConfiguration, StateOptions=JaxStateOptions),
    "port": dict(env=lambda **kw: pds.StreamExecutionEnvironment(
                     device="cpu", **kw),
                 win=pwin, sinks=psinks, sources=psources, fn=pfn,
                 f32=torch.float32, clock=pclock, process=pprocess,
                 state_api=papi, RB=RecordBatch,
                 Config=Configuration, StateOptions=StateOptions),
}


@pytest.fixture(autouse=True)
def _pinned(verdicts):  # noqa: F811 — the fixture
    """Both packages' process-wide calibrations pinned (nothing measured)
    and put back after the test."""
    verdicts(taxed=False, shards=1, super_shards=1, depth=1, probe=False)


def _plain(v):
    return v.item() if isinstance(v, np.generic) else v


def _rows(rows):
    return [{k: _plain(v) for k, v in r.items()} for r in rows]


def both(scenario, *args):
    """``scenario(S, *args)`` through each package; the collected rows must
    be equal, in order.  Returns the port's."""
    want = _rows(scenario(SIDES["jax"], *args))
    got = _rows(scenario(SIDES["port"], *args))
    assert got == want
    return got


def rows_by(rows, *cols):
    return sorted(rows, key=lambda r: tuple(r[c] for c in cols))


# ---------------------------------------------------------------------------
# the cases of tests/test_datastream.py
# ---------------------------------------------------------------------------

def test_map_filter_pipeline():
    def run(S):
        return (S["env"]().from_collection(
            columns={"x": np.arange(10, dtype=np.int64)})
            .map(lambda c: {"x": c["x"], "y": c["x"] * 2})
            .filter(lambda c: c["x"] % 2 == 0)
            .execute_and_collect())
    rows = both(run)
    assert [r["y"] for r in rows_by(rows, "x")] == [0, 4, 8, 12, 16]


def test_flat_map():
    def explode(cols):
        reps = np.asarray(cols["x"]) % 3
        src = np.repeat(np.arange(len(reps)), reps)
        return {"x": np.asarray(cols["x"])[src]}, src

    def run(S):
        return (S["env"]().from_collection(
            columns={"x": np.arange(6, dtype=np.int64)})
            .flat_map(explode).execute_and_collect())
    rows = both(run)
    assert sorted(r["x"] for r in rows) == [1, 2, 2, 4, 5, 5]


def test_keyed_reduce_running_sum():
    def run(S):
        keys = np.asarray([1, 2, 1, 1, 2], dtype=np.int64)
        vals = np.asarray([10.0, 1.0, 20.0, 30.0, 2.0])
        return (S["env"]().from_collection(columns={"k": keys, "v": vals})
                .key_by("k").sum("v").execute_and_collect())
    rows = both(run)
    assert len(rows) == 5
    got = {}
    for r in rows:
        got.setdefault(r["k"], []).append(r["v"])
    assert got[1] == [10.0, 30.0, 60.0] and got[2] == [1.0, 3.0]


def test_keyed_reduce_across_batches():
    n = 1000
    keys = np.arange(n, dtype=np.int64) % 7

    def run(S):
        return (S["env"]().from_collection(
            columns={"k": keys, "v": np.ones(n)}, batch_size=64)
            .key_by("k").sum("v").execute_and_collect())
    rows = both(run)
    assert len(rows) == n
    finals = {r["k"]: r["v"] for r in rows}
    for k in range(7):
        assert finals[k] == np.sum(keys == k)


def test_tumbling_window_sum_e2e():
    def run(S):
        ts = np.asarray([100, 200, 600, 700, 100, 900], dtype=np.int64)
        keys = np.asarray([1, 1, 1, 1, 2, 2], dtype=np.int64)
        vals = np.asarray([1.0, 2.0, 3.0, 4.0, 10.0, 20.0])
        return (S["env"]().from_collection(
            columns={"k": keys, "v": vals, "t": ts})
            .assign_timestamps_and_watermarks(0, timestamp_column="t")
            .key_by("k")
            .window(S["win"].TumblingEventTimeWindows.of(500))
            .sum("v").execute_and_collect())
    rows = both(run)
    got = rows_by([{k: r[k] for k in ("k", "v", "window_start")}
                   for r in rows], "k", "window_start")
    assert got == [
        {"k": 1, "v": 3.0, "window_start": 0},
        {"k": 1, "v": 7.0, "window_start": 500},
        {"k": 2, "v": 10.0, "window_start": 0},
        {"k": 2, "v": 20.0, "window_start": 500},
    ]


def test_sliding_window_e2e():
    def run(S):
        ts = np.asarray([0, 100, 250, 400], dtype=np.int64)
        return (S["env"]().from_collection(
            columns={"k": np.zeros(4, dtype=np.int64), "v": np.ones(4),
                     "t": ts})
            .assign_timestamps_and_watermarks(0, timestamp_column="t")
            .key_by("k")
            .window(S["win"].SlidingEventTimeWindows.of(200, 100))
            .sum("v").execute_and_collect())
    rows = both(run)
    by_start = {r["window_start"]: r["v"] for r in rows}
    assert by_start[0] == 2.0 and by_start[100] == 2.0
    assert by_start[300] == 1.0


def test_wordcount_string_keys():
    """Baseline config #1 shape: text → words → keyBy(word) → tumbling
    count, with string keys (the port's ``ObjectKeyIndex``)."""
    def run(S):
        words = np.asarray(["to", "be", "or", "not", "to", "be"],
                           dtype=object)
        ts = np.asarray([0, 0, 0, 0, 1, 1], dtype=np.int64)
        return (S["env"]().from_collection(columns={"word": words, "t": ts})
                .assign_timestamps_and_watermarks(0, timestamp_column="t")
                .key_by("word")
                .window(S["win"].TumblingEventTimeWindows.of(5000))
                .count().execute_and_collect())
    rows = both(run)
    assert {r["word"]: r["count"] for r in rows} == {"to": 2, "be": 2,
                                                      "or": 1, "not": 1}


def test_union():
    def run(S):
        env = S["env"]()
        a = env.from_collection(columns={"x": np.asarray([1, 2], np.int64)})
        b = env.from_collection(columns={"x": np.asarray([3, 4], np.int64)})
        return a.union(b).execute_and_collect()
    rows = both(run)
    assert sorted(r["x"] for r in rows) == [1, 2, 3, 4]


def test_chaining_fuses_forward_ops():
    def run(S):
        env = S["env"]()
        env.from_collection(columns={"x": np.arange(4, dtype=np.int64)}) \
            .map(lambda c: {"x": c["x"] + 1}) \
            .map(lambda c: {"x": c["x"] * 2}).collect()
        plan = env.get_stream_graph().to_plan()
        return [{"vertices": len(plan.vertices),
                 "chain": [v.name for v in plan.vertices]}]
    assert both(run)[0]["vertices"] == 1


def test_keyby_breaks_chain():
    def run(S):
        env = S["env"]()
        env.from_collection(columns={"k": np.asarray([1], np.int64),
                                     "v": np.asarray([1.0])}) \
            .key_by("k").sum("v").collect()
        plan = env.get_stream_graph().to_plan()
        return [{"vertices": len(plan.vertices)}]
    assert both(run)[0]["vertices"] == 2    # [source+key-by] -> [reduce+sink]


def test_generator_source_unbounded_budget():
    def make(split, b, n):
        return {"v": np.full(n, b, dtype=np.int64)}

    def run(S):
        return (S["env"]().from_source(S["sources"].GeneratorSource(
            make, num_batches=3, batch_size=4)).execute_and_collect())
    assert len(both(run)) == 12


def test_watermarks_flow_to_sink():
    def run(S):
        env = S["env"]()
        sink = S["sinks"].CollectSink()
        wms = []
        sink.on_watermark = wms.append
        env.from_collection(columns={"t": np.asarray([100, 900], np.int64)}) \
            .assign_timestamps_and_watermarks(0, timestamp_column="t") \
            .add_sink(sink)
        env.execute()
        return [{"wm": w} for w in wms]
    wms = [r["wm"] for r in both(run)]
    assert 899 in wms and wms[-1] > 10 ** 15


def test_count_window():
    n = 10

    def run(S, size, slide, batch):
        return (S["env"]().from_collection(
            columns={"k": np.zeros(n, np.int64),
                     "v": np.arange(1, n + 1, dtype=np.float64)},
            batch_size=batch)
            .key_by("k").count_window(size, slide).sum("v")
            .execute_and_collect())
    assert [r["v"] for r in both(run, 5, None, 5)] == [15.0, 40.0]
    assert [r["v"] for r in both(run, 4, 2, 2)] == [3.0, 10.0, 18.0, 26.0,
                                                    34.0]


@pytest.mark.parametrize("maker", ["shuffle", "rescale", "global_"])
def test_explicit_partitioning_methods(maker):
    n = 100

    def run(S):
        s = S["env"]().from_collection(
            columns={"v": np.arange(n, dtype=np.float64)}, batch_size=16)
        return getattr(s, maker)().execute_and_collect(f"{maker}-job")
    assert sum(r["v"] for r in both(run)) == float(n * (n - 1) / 2)


def test_min_by_max_by():
    def run(S, how, cols, batch):
        s = S["env"]().from_collection(columns=cols, batch_size=batch)
        return getattr(s.key_by("k"), how)("v").execute_and_collect()
    rows = both(run, "min_by", {
        "k": np.array([1, 1, 1, 2, 2], np.int64),
        "v": np.array([5., 2., 2., 9., 1.]),
        "tag": np.asarray(["a", "b", "c", "d", "e"], object)}, 2)
    final = {r["k"]: (r["v"], r["tag"]) for r in rows}
    assert final[1] == (2.0, "b") and final[2] == (1.0, "e")
    rows = both(run, "max_by", {
        "k": np.zeros(4, np.int64), "v": np.array([3., 7., 7., 1.]),
        "tag": np.asarray(["p", "q", "r", "s"], object)}, 1)
    assert rows[-1]["tag"] == "q"


def test_min_by_keyed_snapshot_rescale():
    """min_by state follows the keyed-snapshot convention: a rescale split
    routes each key's extreme to its key-group owner (string tags ride
    along), in both packages alike."""
    from flink_tpu.core.batch import RecordBatch as JaxBatch
    from flink_tpu.operators.basic import ExtremumByOperator as JaxExt
    from flink_tpu.state.redistribute import split_keyed_snapshot as jsplit
    from flink_tpu_torch.core.batch import RecordBatch
    from flink_tpu_torch.operators.basic import ExtremumByOperator
    from flink_tpu_torch.state.redistribute import split_keyed_snapshot

    found = {}
    for side, (Op, RB, split) in {
            "jax": (JaxExt, JaxBatch, jsplit),
            "port": (ExtremumByOperator, RecordBatch,
                     split_keyed_snapshot)}.items():
        op = Op("k", "v", is_min=True)
        op.process_batch(RB({
            "k": np.array([1, 2, 3, 1], np.int64),
            "v": np.array([5., 7., 2., 1.]),
            "tag": np.asarray(["a", "b", "c", "d"], object)}))
        snap = op.snapshot_state()
        parts = split(snap, [f for f in snap if f.startswith("state.")],
                      128, 2)
        found[side] = {}
        for p in parts:
            op2 = Op("k", "v", is_min=True)
            op2.restore_state(p)
            out = op2.process_batch(RB({
                "k": np.array([1, 2, 3], np.int64),
                "v": np.array([99., 99., 99.]),
                "tag": np.asarray(["x", "x", "x"], object)}))
            for r in out[0].to_rows():
                if r["tag"] != "x":
                    found[side][r["k"]] = (r["v"], r["tag"])
    assert found["port"] == found["jax"] \
        == {1: (1.0, "d"), 2: (7.0, "b"), 3: (2.0, "c")}


def test_min_by_emits_triggering_timestamp():
    from flink_tpu_torch.core.batch import RecordBatch
    from flink_tpu_torch.operators.basic import ExtremumByOperator

    op = ExtremumByOperator("k", "v", is_min=True)
    op.process_batch(RecordBatch({"k": np.zeros(1, np.int64),
                                  "v": np.array([1.])},
                                 timestamps=np.array([100], np.int64)))
    out = op.process_batch(RecordBatch({"k": np.zeros(1, np.int64),
                                        "v": np.array([9.])},
                                       timestamps=np.array([50_000],
                                                           np.int64)))
    assert np.asarray(out[0].timestamps)[0] == 50_000
    assert out[0].to_rows()[0]["v"] == 1.0


# ---------------------------------------------------------------------------
# the canonical flow, window options, sessions, evictors, process
# ---------------------------------------------------------------------------

CANON = [{"k": k, "v": 1.0, "ts": t} for t in range(0, 1000, 10)
         for k in ("a", "b")]


@pytest.mark.parametrize("opts", [
    {},
    {"emit_tier": "host"},
    {"emit_tier": "device"},
    {"emit_tier": "host", "superbatch": 4},
    {"emit_tier": "host", "pipeline_depth": 2},
    {"emit_tier": "host", "native_shards": 2, "device_probe": "off"},
], ids=["default", "host", "device", "superbatch", "pipelined", "shards"])
def test_canonical_flow_string_keys(opts):
    """The verify skill's canonical flow, string keys, with the window
    operator's options: every row equals JAX's."""
    def run(S):
        return (S["env"]().from_collection(CANON, timestamp_column="ts")
                .assign_timestamps_and_watermarks(0, timestamp_column="ts")
                .key_by("k")
                .window(S["win"].TumblingEventTimeWindows.of(100))
                .aggregate(S["fn"].SumAggregator(S["f32"]), value_column="v",
                           **opts)
                .execute_and_collect())
    rows = both(run)
    assert len(rows) == 20 and {r["result"] for r in rows} == {10.0}
    assert {r["k"] for r in rows} == {"a", "b"}


def test_paged_window_job_equals_jax():
    from flink_tpu.state.paging import PagingConfig as JaxPaging
    from flink_tpu_torch.state.paging import PagingConfig

    rng = np.random.default_rng(3)
    keys = np.char.add("w", rng.integers(0, 300, 3000).astype(str))
    cols = {"k": keys.astype(object), "v": rng.random(3000).astype(np.float32),
            "t": np.sort(rng.integers(0, 2000, 3000)).astype(np.int64)}

    def run(S):
        cfg = (JaxPaging if S is SIDES["jax"] else PagingConfig)(
            capacity=64)
        return (S["env"]().from_collection(columns=cols, batch_size=500,
                                           timestamp_column="t")
                .assign_timestamps_and_watermarks(0, timestamp_column="t")
                .key_by("k")
                .window(S["win"].TumblingEventTimeWindows.of(500))
                .aggregate(S["fn"].SumAggregator(S["f32"]), value_column="v",
                           paging=cfg)
                .execute_and_collect())
    assert len(both(run)) > 300


def test_session_and_evictor_routes_equal_jax():
    from flink_tpu.windowing.evictors import CountEvictor as JaxCount
    from flink_tpu_torch.windowing.evictors import CountEvictor

    rng = np.random.default_rng(8)
    cols = {"k": rng.integers(0, 20, 800).astype(np.int64),
            "v": rng.random(800).astype(np.float32),
            "t": np.sort(rng.integers(0, 4000, 800)).astype(np.int64)}

    def run(S, route):
        ks = (S["env"]().from_collection(columns=cols, batch_size=200)
              .assign_timestamps_and_watermarks(0, timestamp_column="t")
              .key_by("k"))
        agg = S["fn"].SumAggregator(S["f32"])
        if route == "session":
            w = ks.window(S["win"].EventTimeSessionWindows(40))
        else:
            ev = (JaxCount if S is SIDES["jax"] else CountEvictor).of(3)
            w = ks.window(S["win"].TumblingEventTimeWindows.of(500)) \
                .evictor(ev)
        return w.aggregate(agg, value_column="v").execute_and_collect()
    for route in ("session", "evictor"):
        assert both(run, route), route


@pytest.mark.parametrize("backend", ["heap", "changelog"])
def test_keyed_process_route_over_the_configured_backend(backend):
    """``KeyedStream.process`` over ``make_keyed_backend``: a running sum
    per key in a ``ValueState`` and an event-time timer a key."""
    def run(S):
        class RunningSum(S["process"].KeyedProcessFunction):
            def __init__(self):
                self.d = S["state_api"].ValueStateDescriptor(
                    "total", dtype=np.float64, default=0.0)

            def process_batch(self, ctx, batch):
                st = ctx.state(self.d)
                u, inv = np.unique(ctx.slots, return_inverse=True)
                sums = np.bincount(inv, weights=np.asarray(batch.column("v")))
                cur, _ = st.get_rows(u)
                st.put_rows(u, cur + sums)
                return [S["RB"]({"k": ctx.keys_of(u), "total": cur + sums})]

        cfg = S["Config"]()
        cfg.set(S["StateOptions"].BACKEND, backend)
        cols = {"k": np.array([1, 2, 1, 3, 1], np.int64),
                "v": np.array([1.0, 2.0, 3.0, 4.0, 5.0])}
        return (S["env"](config=cfg).from_collection(columns=cols,
                                                    batch_size=2)
                .key_by("k").process(RunningSum()).execute_and_collect())
    assert both(run)


def test_spill_backend_and_later_routes_raise(monkeypatch):
    """The name is from when the spill backend and most routes raised.
    Every route is ported now (the MiniCluster's came last, and its parity
    is ``tests/test_torch_cluster_cases.py``'s): ``execute_cluster`` runs
    on the CPU when asked and raises without a card otherwise; the spill
    backends build (their state is held to JAX's in
    ``tests/test_torch_spill_state.py``), and ``set_mesh()`` without cards
    raises as ``make_mesh`` does; nothing falls back."""
    from flink_tpu_torch.datastream.api import LATER
    assert LATER == {}
    env = pds.StreamExecutionEnvironment(device="cpu")
    env.from_collection(columns={"k": np.arange(4)}).collect()
    assert env.execute_cluster(timeout_s=60).state == "FINISHED"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pds.StreamExecutionEnvironment().execute_cluster()
    with pytest.raises(RuntimeError, match="CUDA devices"):
        env.set_mesh()
    with pytest.raises(RuntimeError, match="CUDA devices"):
        env.set_mesh(n_devices=4)
    from flink_tpu_torch.state import make_keyed_backend
    from flink_tpu_torch.state.changelog import ChangelogKeyedStateBackend
    from flink_tpu_torch.state.spill import SpillKeyedStateBackend
    for name in ("spill", "changelog-spill"):
        cfg = Configuration()
        cfg.set(StateOptions.BACKEND, name)
        b = make_keyed_backend(cfg)
        inner = b.inner if name == "changelog-spill" else b
        assert isinstance(inner, SpillKeyedStateBackend)
        assert isinstance(b, ChangelogKeyedStateBackend) \
            == (name == "changelog-spill")
        inner.close()
    cfg = Configuration()
    cfg.set(StateOptions.BACKEND, "nope")
    with pytest.raises(ValueError, match="unknown state.backend"):
        make_keyed_backend(cfg)


def test_device_operators_default_to_the_card(monkeypatch):
    """A job's device operators run on the card unless the environment asks
    for the CPU: without one, building the job raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = pds.StreamExecutionEnvironment()
    (env.from_collection(CANON, timestamp_column="ts")
     .assign_timestamps_and_watermarks(0, timestamp_column="ts")
     .key_by("k").window(pwin.TumblingEventTimeWindows.of(100))
     .sum("v").collect())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        env.execute()
    host_only = pds.StreamExecutionEnvironment()
    rows = host_only.from_collection(
        columns={"x": np.arange(3, dtype=np.int64)}).execute_and_collect()
    assert [r["x"] for r in rows] == [0, 1, 2]


class _Store:
    """The smallest checkpoint storage: ``store(id, snapshot)``."""

    def __init__(self):
        self.snaps = {}

    def store(self, checkpoint_id, snapshot):
        self.snaps[checkpoint_id] = snapshot


def _window_snapshot(tree):
    """The window operator's snapshot inside a job checkpoint (vertices ->
    chains -> members)."""
    if isinstance(tree, dict):
        if "key_index" in tree and "pane_base" in tree:
            return tree
        for v in tree.values():
            found = _window_snapshot(v)
            if found is not None:
                return found
    return None


def test_checkpoints_go_to_any_store_and_restore_across_packages():
    """A periodic checkpoint of a string-keyed window job lands in a
    ``store`` object; the window operator's state in it restores into
    either package's operator (``interop``), and both fire the same rows."""
    from flink_tpu.core.batch import Watermark as JaxWatermark
    from flink_tpu.operators.window_agg import WindowAggOperator as JaxOp
    from flink_tpu_torch.core.batch import Watermark
    from flink_tpu_torch.interop import snapshot_to_jax
    from flink_tpu_torch.operators.window_agg import WindowAggOperator

    cols = {"k": np.asarray(["a", "b", "c", "a"] * 50, object),
            "v": np.ones(200, np.float32),
            "t": np.arange(200, dtype=np.int64) * 10}
    store = _Store()
    env = pds.StreamExecutionEnvironment(device="cpu")
    env.enable_checkpointing(1, store)
    sink = (env.from_collection(columns=cols, batch_size=20)
            .assign_timestamps_and_watermarks(0, timestamp_column="t")
            .key_by("k").window(pwin.TumblingEventTimeWindows.of(500))
            .sum("v", dtype=torch.float32).collect())
    env.execute()
    assert store.snaps and sink.rows()
    snap = _window_snapshot(store.snaps[min(store.snaps)])
    assert snap["key_index_kind"] == "ObjectKeyIndex"
    fired = {}
    for side, (Op, WM, conv, kw) in {
            "jax": (JaxOp, JaxWatermark, snapshot_to_jax, {}),
            "port": (WindowAggOperator, Watermark, dict,
                     {"device": "cpu"})}.items():
        S = SIDES[side]
        op = Op(S["win"].TumblingEventTimeWindows.of(500),
                S["fn"].SumAggregator(S["f32"]), key_column="k",
                value_column="v", emit_tier="host",
                snapshot_source="mirror", **kw)
        op.open(S["fn"].RuntimeContext())
        op.restore_state(conv(snap))
        fired[side] = _rows(r for b in op.process_watermark(WM(10 ** 6))
                            for r in b.to_rows())
    assert fired["port"] == fired["jax"] and fired["port"]


# ---------------------------------------------------------------------------
# processing time
# ---------------------------------------------------------------------------

class _TestClock:
    """Stands in for the clock seam's wall clock in both packages."""

    def __init__(self, start=10_000):
        self.now = start

    def __call__(self):
        return self.now


@pytest.mark.parametrize("assigner", ["tumbling", "sliding"])
def test_processing_time_windows_equal_jax(monkeypatch, assigner):
    """Processing-time windows through the clock seam: each batch's records
    take the clock's time, the executor's tick fires the windows it passed,
    and the rows equal JAX's with the same clock."""
    clock = _TestClock()
    for S in SIDES.values():
        monkeypatch.setattr(S["clock"], "now_ms", clock)

    def batches():
        for i in range(8):
            clock.now += 300
            yield {"k": np.asarray(["a", "b", "a"], object),
                   "v": np.ones(3, np.float32) * (i + 1)}

    def run(S):
        src = S["sources"].GeneratorSource(
            lambda split, b, n, it=iter(list(batches())): next(it),
            num_batches=8, batch_size=3)
        win = S["win"]
        asg = (win.TumblingProcessingTimeWindows.of(1000)
               if assigner == "tumbling"
               else win.SlidingProcessingTimeWindows.of(1000, 500))
        clock.now = 10_000
        return (S["env"]().from_source(src).key_by("k").window(asg)
                .aggregate(S["fn"].SumAggregator(S["f32"]), value_column="v")
                .execute_and_collect())
    rows = both(run)
    assert rows and {r["k"] for r in rows} == {"a", "b"}


def test_processing_time_operator_ticks_and_gate():
    """The window operator's processing-time hooks alone, against JAX's:
    records take the seam's time, ``on_processing_time`` fires, the
    lateness gate reads processing time, and event-time windows ignore the
    tick."""
    from flink_tpu.core.batch import RecordBatch as JaxBatch
    from flink_tpu.operators.window_agg import WindowAggOperator as JaxOp
    from flink_tpu_torch.core.batch import RecordBatch
    from flink_tpu_torch.operators.window_agg import WindowAggOperator

    outs = {}
    for side, (Op, RB, kw) in {
            "jax": (JaxOp, JaxBatch, {}),
            "port": (WindowAggOperator, RecordBatch,
                     {"device": "cpu"})}.items():
        S = SIDES[side]
        op = Op(S["win"].TumblingProcessingTimeWindows.of(100),
                S["fn"].SumAggregator(S["f32"]), key_column="k",
                value_column="v", emit_tier="host", **kw)
        op.open(S["fn"].RuntimeContext())
        op._now_ms = lambda: 150
        out = op.process_batch(RB({"k": np.array([1, 2, 1], np.int64),
                                   "v": np.ones(3, np.float32)}))
        out += op.on_processing_time(120)      # window [100, 200) still open
        out += op.on_processing_time(250)      # fires it
        op._now_ms = lambda: 180               # beyond lateness: dropped
        out += op.process_batch(RB({"k": np.array([1], np.int64),
                                    "v": np.ones(1, np.float32)}))
        out += op.on_processing_time(240)      # monotone: no rewind
        outs[side] = ([r for b in out for r in b.to_rows()],
                      op.late_dropped)
        ev = Op(S["win"].TumblingEventTimeWindows.of(100),
                S["fn"].SumAggregator(S["f32"]), key_column="k",
                value_column="v", **kw)
        assert ev.on_processing_time(10 ** 9) == []
    assert _rows(outs["port"][0]) == _rows(outs["jax"][0])
    assert outs["port"][1] == outs["jax"][1] == 1
    assert [r["result"] for r in outs["port"][0]] == [2.0, 1.0]


# ---------------------------------------------------------------------------
# the socket source
# ---------------------------------------------------------------------------

def _serve(lines, ready):
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    ready.append(srv.getsockname()[1])

    def loop():
        conn, _ = srv.accept()
        with conn:
            conn.sendall("".join(line + "\n" for line in lines).encode())
        srv.close()
    t = threading.Thread(target=loop, daemon=True)
    t.start()
    return t


def test_socket_word_count_equals_jax():
    """``examples/socket_window_word_count.py``'s shape on a loopback
    server: lines, ``flat_map`` into words, ``key_by(word)``, a processing-
    time window and ``count``; bounded by the server closing.  Per-word
    totals equal the input's, and JAX's."""
    lines = ["to be or not to be", "that is the question", "to be"]

    def split(cols):
        words, src = [], []
        for i, line in enumerate(np.asarray(cols["line"]).tolist()):
            ws = line.split()
            words += ws
            src += [i] * len(ws)
        return ({"word": np.asarray(words, object)},
                np.asarray(src, np.int64))

    def run(S):
        ready = []
        t = _serve(lines, ready)
        rows = (S["env"]().socket_text_stream("127.0.0.1", ready[0])
                .flat_map(split).key_by("word")
                .window(S["win"].TumblingProcessingTimeWindows.of(60_000))
                .count().execute_and_collect())
        t.join(timeout=10)
        assert not t.is_alive()
        totals = {}
        for r in rows:
            totals[r["word"]] = totals.get(r["word"], 0) + r["count"]
        return [totals]
    totals = both(run)[0]
    want = {}
    for w in " ".join(lines).split():
        want[w] = want.get(w, 0) + 1
    assert totals == want

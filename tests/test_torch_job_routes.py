"""Port parity for the rest of the local job path and the DataStream routes
to the ported operators: ``flink_tpu_torch`` against ``flink_tpu`` on the
CPU, on the same numpy inputs.

- Processing-time sessions under the operator harness's
  ``TestProcessingTimeService`` and through a job on a test clock.
- Latency markers at the sink (through a chain, on the clock seam).
- The operator harness itself (``testing/harness.py``): elements,
  watermarks, processing time, output extraction, ``restored``,
  ``sorted_rows``.
- The environment's mesh (``StreamExecutionEnvironment(mesh=)``) at D = 1,
  2 and 4 blocks on ``["cpu"] * D``, for windows and sessions, with
  checkpoints: the cases of ``tests/test_mesh_runtime.py`` that build jobs.
  The JAX side runs on the conftest's CPU devices (``set_mesh``).
- ``CEP.pattern(keyed, pattern).select(fn)`` against JAX's, on both
  engines.
- The DataStream cases of ``tests/test_count_window_slide.py``,
  ``tests/test_session_windows.py`` and ``tests/test_evicting_device.py``.

Each job runs through both packages (:func:`both`): the rows must be equal,
in order, unless a case sorts them; the reference test's expectation is
asserted on the port's rows.  Values compared are exact in both packages
(the port's ``sum`` defaults to f64 where JAX's asks for ``jnp.float64``,
which JAX without x64 holds as f32; the jobs here sum values exact in
either).  Every verdict is pinned and restored.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_tpu import datastream as jds
from flink_tpu import windowing as jwin
from flink_tpu.cep import CEP as JaxCEP
from flink_tpu.cep import Pattern as JaxPattern
from flink_tpu.connectors import sources as jsources
from flink_tpu.core import batch as jbatch
from flink_tpu.core import functions as jfn
from flink_tpu.operators import basic as jbasic
from flink_tpu.operators import chain as jchain
from flink_tpu.operators import evicting_device as jed
from flink_tpu.operators import session_window as jsw
from flink_tpu.operators import window_agg as jwa
from flink_tpu.parallel import mesh_runtime as jmr
from flink_tpu.testing import harness as jharness
from flink_tpu.utils import clock as jclock
from flink_tpu.windowing import evictors as jevictors
from flink_tpu_torch import datastream as pds
from flink_tpu_torch import testing as ptesting
from flink_tpu_torch import windowing as pwin
from flink_tpu_torch.cep import CEP, Pattern
from flink_tpu_torch.connectors import sources as psources
from flink_tpu_torch.core import batch as pbatch
from flink_tpu_torch.core import functions as pfn
from flink_tpu_torch.operators import basic as pbasic
from flink_tpu_torch.operators import chain as pchain
from flink_tpu_torch.operators import evicting_device as ped
from flink_tpu_torch.operators import session_window as psw
from flink_tpu_torch.operators import window_agg as pwa
from flink_tpu_torch.parallel import mesh as pmesh
from flink_tpu_torch.parallel import mesh_runtime as pmr
from flink_tpu_torch.testing import harness as pharness
from flink_tpu_torch.utils import clock as pclock
from flink_tpu_torch.windowing import evictors as pevictors
from test_torch_calibration import verdicts  # noqa: F401 — the fixture

SIDES = {
    "jax": dict(env=lambda **kw: jds.StreamExecutionEnvironment(**kw),
                win=jwin, batch=jbatch, fn=jfn, f32=jnp.float32,
                sources=jsources, basic=jbasic, chain=jchain,
                ed=jed, sw=jsw, wa=jwa, mr=jmr, harness=jharness,
                clock=jclock, ev=jevictors, CEP=JaxCEP, Pattern=JaxPattern,
                mesh_env=lambda D: jds.StreamExecutionEnvironment()
                .set_mesh(n_devices=D), kw={}),
    "port": dict(env=lambda **kw: pds.StreamExecutionEnvironment(
                     device="cpu", **kw),
                 win=pwin, batch=pbatch, fn=pfn, f32=torch.float32,
                 sources=psources, basic=pbasic, chain=pchain,
                 ed=ped, sw=psw, wa=pwa, mr=pmr, harness=pharness,
                 clock=pclock, ev=pevictors, CEP=CEP, Pattern=Pattern,
                 mesh_env=lambda D: pds.StreamExecutionEnvironment(
                     device="cpu", mesh=pmesh.make_mesh(devices=["cpu"] * D)),
                 kw={"device": "cpu"}),
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
    """``scenario(S, *args)`` through each package; equal results.
    Returns the port's."""
    want = _plain(scenario(SIDES["jax"], *args))
    got = _plain(scenario(SIDES["port"], *args))
    assert got == want
    return got


class _TestClock:
    """Stands in for the clock seam's wall clock in both packages."""

    def __init__(self, start=10_000):
        self.now = start

    def __call__(self):
        return self.now


# ---------------------------------------------------------------------------
# processing-time sessions
# ---------------------------------------------------------------------------

def test_processing_time_sessions_under_the_test_time_service():
    """Arrival times from the harness's time service: records stamped at
    the last tick, a tick fires the sessions whose gap closed, watermarks
    fire nothing, ``end_input`` fires the rest; equal to JAX's."""
    def run(S):
        op = S["sw"].SessionWindowOperator(
            S["win"].ProcessingTimeSessionWindows(100),
            S["fn"].SumAggregator(S["f32"]), key_column="k",
            value_column="v")
        h = S["harness"].KeyedOneInputOperatorHarness(op)
        RB = S["batch"].RecordBatch
        seen = []
        h.set_processing_time(1_000)
        h.process_batch(RB({"k": np.array([1, 2, 1]),
                            "v": np.array([1., 2., 3.], np.float32)}))
        h.set_processing_time(1_050)
        h.process_batch(RB({"k": np.array([1]),
                            "v": np.array([4.], np.float32)}))
        h.process_watermark(1 << 40)
        seen.append(h.extract_output_rows())
        h.set_processing_time(1_100)             # key 2's gap closed
        seen.append(h.extract_output_rows())
        h.set_processing_time(900)               # a clock stepped back
        h.process_batch(RB({"k": np.array([3]),
                            "v": np.array([5.], np.float32)}))
        snap = h.snapshot()
        h.end_input()
        seen.append(h.extract_output_rows())
        seen.append(h.extract_watermarks())
        h2 = S["harness"].KeyedOneInputOperatorHarness.restored(
            S["sw"].SessionWindowOperator(
                S["win"].ProcessingTimeSessionWindows(100),
                S["fn"].SumAggregator(S["f32"]), key_column="k",
                value_column="v"), snap)
        h2.end_input()
        seen.append(h2.extract_output_rows())
        return seen
    seen = both(run)
    assert seen[0] == []
    assert [(r["k"], r["window_start"], r["window_end"]) for r in seen[1]] \
        == [(2, 1000, 1100)]
    assert sorted((r["k"], r["window_start"], r["window_end"], r["result"])
                  for r in seen[2]) == [(1, 1000, 1150, 8.0),
                                        (2, 1000, 1100, 2.0),
                                        (3, 1100, 1200, 5.0)]
    assert seen[3] == [1 << 40]
    assert sorted(r["k"] for r in seen[4]) == [1, 3]


def test_processing_time_session_job_equals_jax(monkeypatch):
    """A job with ``ProcessingTimeSessionWindows`` on a test clock: each
    batch's records take the clock's time, the executor's tick closes the
    sessions; the rows equal JAX's."""
    clock = _TestClock()
    for S in SIDES.values():
        monkeypatch.setattr(S["clock"], "now_ms", clock)

    def run(S):
        times = iter([10_000, 10_040, 10_090, 10_500, 10_520, 11_200,
                      11_210, 11_220])

        def gen(split, b, n):
            clock.now = next(times)
            return {"k": np.asarray([b % 3, 7], np.int64),
                    "v": np.asarray([1.0, float(b)], np.float32)}

        clock.now = 10_000
        return (S["env"]().from_source(S["sources"].GeneratorSource(
            gen, num_batches=8, batch_size=2))
            .key_by("k")
            .window(S["win"].ProcessingTimeSessionWindows(200))
            .aggregate(S["fn"].SumAggregator(S["f32"]), value_column="v")
            .execute_and_collect())
    rows = both(run)
    assert {r["k"] for r in rows} == {0, 1, 2, 7}
    assert sum(r["result"] for r in rows if r["k"] == 7) == float(sum(
        range(8)))


# ---------------------------------------------------------------------------
# latency markers
# ---------------------------------------------------------------------------

def test_latency_markers_reach_the_sink_through_a_chain(monkeypatch):
    """A chain of a map and a sink: the marker skips the map and is sampled
    at the sink against the clock seam, as JAX's."""
    now = [2_000.5]
    for S in SIDES.values():
        monkeypatch.setattr(S["clock"], "now_ms_f", lambda: now[0])

    def run(S):
        class Sink:
            def write_batch(self, b):
                pass

        sink_op = S["basic"].SinkOperator(Sink())
        chain = S["chain"].ChainedOperator(
            [S["basic"].MapOperator(lambda c: c), sink_op])
        out = []
        for t in (1.9, 1.5, 2.5):       # the last one: a skewed clock
            out += chain.on_latency_marker(S["batch"].LatencyMarker(t))
        passed = S["chain"].ChainedOperator(
            [S["basic"].MapOperator(lambda c: c)]).on_latency_marker(
            S["batch"].LatencyMarker(1.0))
        return out, sink_op.latencies_ms, len(passed)
    out, samples, passed = both(run)
    assert out == [] and passed == 1
    assert samples == pytest.approx([100.5, 500.5, 0.0])


# ---------------------------------------------------------------------------
# the operator harness
# ---------------------------------------------------------------------------

def test_harness_drives_a_window_operator_like_jax():
    """``process_elements``, ``process_watermark``, processing time through
    the operator's ``_now_ms``, the extractors and ``restored``."""
    def run(S):
        def op():
            return S["wa"].WindowAggOperator(
                S["win"].TumblingProcessingTimeWindows.of(100),
                S["fn"].SumAggregator(S["f32"]), key_column="k",
                value_column="v", **S["kw"])
        h = S["harness"].KeyedOneInputOperatorHarness(op())
        h.set_processing_time(1_000)
        h.process_elements([{"k": 1, "v": np.float32(1.0)},
                            {"k": 2, "v": np.float32(2.0)}])
        snap = h.snapshot()
        h.set_processing_time(1_050)
        h.process_elements([{"k": 1, "v": np.float32(4.0)}])
        h.process_watermark(5)
        h.set_processing_time(1_100)
        rows = S["harness"].sorted_rows(h.extract_output_rows(), ("k",))
        wms = h.extract_watermarks()
        n_batches = len(h.extract_output_batches())
        h.clear_output()
        h2 = S["harness"].KeyedOneInputOperatorHarness.restored(op(), snap)
        h2.set_processing_time(1_100)
        return rows, wms, n_batches, h.output, h2.extract_output_rows()
    rows, wms, n, cleared, restored = both(run)
    assert [(r["k"], r["result"], r["__ts__"]) for r in rows] == \
        [(1, 5.0, 1099), (2, 2.0, 1099)]
    assert wms == [5] and n == 1 and cleared == []
    assert sorted((r["k"], r["result"]) for r in restored) == [(1, 1.0),
                                                               (2, 2.0)]


def test_testing_package_exports_lazily():
    """``flink_tpu_torch.testing`` exports JAX's names (``workload`` is not
    ported) and loads the harness only when asked."""
    import flink_tpu.testing as jtesting
    assert ptesting.__all__ == jtesting.__all__
    assert ptesting.KeyedOneInputOperatorHarness \
        is pharness.KeyedOneInputOperatorHarness
    assert ptesting.TestProcessingTimeService.__name__ == \
        "TestProcessingTimeService"
    assert ptesting.chaos.__name__ == "flink_tpu_torch.testing.chaos"
    with pytest.raises(AttributeError):
        getattr(ptesting, "workload")
    svc = ptesting.TestProcessingTimeService(5)
    assert (svc.advance_to(3), svc.advance_to(9)) == (5, 9)


# ---------------------------------------------------------------------------
# the environment's mesh
# ---------------------------------------------------------------------------

def _wordcount(env, n=5000, n_keys=37):
    words = (np.arange(n) % n_keys).astype(np.int64)
    return (env.from_collection(
        columns={"word": words, "one": np.ones(n, np.float32)},
        batch_size=512)
        .assign_timestamps_and_watermarks(0, timestamp_column="word")
        .key_by("word")
        .window(pwin.TumblingEventTimeWindows.of(10_000)
                if isinstance(env, pds.StreamExecutionEnvironment)
                else jwin.TumblingEventTimeWindows.of(10_000))
        .sum("one").collect()), {k: float(np.sum(words == k))
                                 for k in range(n_keys)}


@pytest.mark.parametrize("D", [1, 2, 4])
def test_mesh_job_through_env_execute(D):
    """A WordCount job on a mesh of D blocks through the normal DataStream
    path lands on the mesh operator; its rows equal JAX's mesh job's, and
    the word counts are exact."""
    def run(S):
        env = S["mesh_env"](D)
        sink, want = _wordcount(env)
        env.execute()
        ops = [m for rv in env._last_executor.running.values()
               for m in getattr(rv.operator, "operators", [rv.operator])]
        assert any(isinstance(m, S["mr"].MeshWindowAggOperator)
                   for m in ops)
        return sink.rows(), want
    rows, want = both(run)
    assert {int(r["word"]): float(r["one"]) for r in rows} == want


@pytest.mark.parametrize("D", [2, 4])
def test_mesh_env_equals_the_mesh_operator_driven_directly(D):
    """The environment's route gives the rows of the mesh operator driven
    by hand over the same batches (the port's own, no JAX)."""
    rng = np.random.default_rng(8)
    batches = [(rng.integers(0, 400, 1000).astype(np.int64),
                rng.random(1000).astype(np.float32),
                (i * 250 + np.sort(rng.integers(0, 250, 1000))).astype(
                    np.int64)) for i in range(8)]
    env = pds.StreamExecutionEnvironment(
        device="cpu", mesh=pmesh.make_mesh(devices=["cpu"] * D))
    cols = {"k": np.concatenate([b[0] for b in batches]),
            "v": np.concatenate([b[1] for b in batches]),
            "t": np.concatenate([b[2] for b in batches])}
    rows = (env.from_collection(columns=cols, batch_size=1000)
            .assign_timestamps_and_watermarks(0, timestamp_column="t")
            .key_by("k").window(pwin.TumblingEventTimeWindows.of(500))
            .aggregate(pfn.SumAggregator(torch.float32), value_column="v")
            .execute_and_collect())
    op = pmr.MeshWindowAggOperator(
        pwin.TumblingEventTimeWindows.of(500),
        pfn.SumAggregator(torch.float32), key_column="k", value_column="v",
        mesh=pmesh.make_mesh(devices=["cpu"] * D))
    op.open(pfn.RuntimeContext())
    out = []
    for k, v, t in batches:
        out += op.process_batch(pbatch.RecordBatch({"k": k, "v": v},
                                                   timestamps=t))
        out += op.process_watermark(pbatch.Watermark(int(t.max())))
    out += op.process_watermark(pbatch.Watermark(pbatch.MAX_WATERMARK))
    want = [r for b in out for r in b.to_rows()]
    rows = [{c: v for c, v in r.items() if c != "__ts__"} for r in rows]
    key = lambda r: (r["window_start"], r["k"])  # noqa: E731
    assert sorted(_plain(rows), key=key) == sorted(_plain(want), key=key)


def test_mesh_sessions_through_env():
    """Sessions on the environment's mesh land on the mesh session operator;
    rows equal JAX's mesh job's and the single-block job's."""
    rng = np.random.default_rng(6)
    n = 4000
    cols = {"k": rng.integers(0, 60, n).astype(np.int64),
            "v": rng.integers(0, 8, n).astype(np.float32),
            "t": np.sort(rng.integers(0, 40_000, n)).astype(np.int64)}

    def run(S, D):
        env = S["mesh_env"](D) if D else S["env"]()
        return (env.from_collection(columns=cols, batch_size=700)
                .assign_timestamps_and_watermarks(0, timestamp_column="t")
                .key_by("k").window(S["win"].EventTimeSessionWindows(300))
                .aggregate(S["fn"].SumAggregator(S["f32"]), value_column="v")
                .execute_and_collect())
    key = lambda r: (r["k"], r["window_start"])  # noqa: E731
    for D in (2, 4):
        rows = both(run, D)
        single = both(run, 0)
        assert sorted(rows, key=key) == sorted(single, key=key) and rows


def test_mesh_job_with_checkpoint_through_env():
    """Checkpoints of a mesh job through the environment: the stored
    snapshots hold the mesh operator's state; the counts are exact."""
    class Store:
        def __init__(self):
            self.snaps = {}

        def store(self, cid, snap):
            self.snaps[cid] = snap

    store = Store()
    env = SIDES["port"]["mesh_env"](4)
    env.enable_checkpointing(1, storage=store)
    sink, want = _wordcount(env)
    env.execute()
    assert {int(r["word"]): float(r["one"]) for r in sink.rows()} == want
    assert store.snaps

    def has_leaves(tree):
        if isinstance(tree, dict):
            return "leaves" in tree or any(has_leaves(v)
                                           for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return any(has_leaves(v) for v in tree)
        return False
    assert has_leaves(store.snaps[max(store.snaps)])


def test_mesh_env_refuses_paging_and_warns_for_host_lanes():
    """Paging and ``emit_tier`` refuse a mesh environment, the evicting
    lanes warn that they run on one device, as JAX's."""
    env = SIDES["port"]["mesh_env"](2)
    ws = (env.from_collection(columns={"k": np.zeros(2, np.int64),
                                       "v": np.ones(2),
                                       "t": np.arange(2)})
          .assign_timestamps_and_watermarks(0, timestamp_column="t")
          .key_by("k").window(pwin.TumblingEventTimeWindows.of(10)))
    with pytest.raises(ValueError, match="mesh-sharded"):
        ws.aggregate(pfn.SumAggregator(), value_column="v",
                     emit_tier="device")
    with pytest.warns(UserWarning, match="single device"):
        ws.evictor(pwin.CountEvictor.of(1)).sum("v")
    ws2 = (env.from_collection(columns={"k": np.zeros(2, np.int64)})
           .key_by("k").window(pwin.TumblingEventTimeWindows.of(10)))
    with pytest.warns(UserWarning, match="on the host"):
        ws2.apply(lambda k, w, rows: {"n": len(rows)})


# ---------------------------------------------------------------------------
# CEP through the DataStream API
# ---------------------------------------------------------------------------

def _cep_job(S, pattern_fn, rows, vectorized="auto"):
    env = S["env"]()
    stream = (env.from_collection(rows, timestamp_column="ts")
              .assign_timestamps_and_watermarks(0, timestamp_column="ts")
              .key_by("k"))
    sink = S["CEP"].pattern(stream, pattern_fn(S)).select(
        lambda m: {"k": m["start"][0]["k"],
                   "vals": ",".join(str(e["v"]) for st in sorted(m)
                                    for e in m[st])},
        vectorized=vectorized).collect()
    env.execute("cep")
    return [{k: v for k, v in r.items() if k != "__ts__"}
            for r in sink.rows()]


def _followed_by(S):
    P = S["Pattern"]
    return (P.begin("start").where(lambda c: np.asarray(c["type"]) == "a")
            .followed_by("end").where(lambda c: np.asarray(c["type"]) == "b"))


def _strict_within(S):
    P = S["Pattern"]
    return (P.begin("start").where(lambda c: np.asarray(c["v"]) > 5)
            .next("end").where(lambda c: np.asarray(c["v"]) < 3)
            .within(50))


def _cep_rows(seed=12, n=400):
    rng = np.random.default_rng(seed)
    types = np.asarray(["a", "b", "x"], object)[rng.integers(0, 3, n)]
    return [{"k": int(k), "type": str(t), "v": int(v), "ts": int(ts)}
            for k, t, v, ts in zip(rng.integers(0, 12, n), types,
                                   rng.integers(0, 10, n),
                                   np.sort(rng.integers(0, 2000, n)))]


@pytest.mark.parametrize("vectorized", ["on", "off", "auto"])
@pytest.mark.parametrize("pattern", ["followed_by", "strict_within"])
def test_cep_select_equals_jax(pattern, vectorized):
    fn = {"followed_by": _followed_by, "strict_within": _strict_within}[
        pattern]
    rows = both(_cep_job, fn, _cep_rows(), vectorized)
    assert rows


def test_cep_select_basic_case():
    """``tests/test_cep.py::test_followed_by_basic`` through both
    packages."""
    rows = [{"k": "u", "type": "a", "v": 1, "ts": 1},
            {"k": "u", "type": "x", "v": 2, "ts": 2},
            {"k": "u", "type": "b", "v": 3, "ts": 3},
            {"k": "w", "type": "b", "v": 9, "ts": 4}]
    out = both(_cep_job, _followed_by, rows)
    assert out == [{"k": "u", "vals": "3,1"}]


def test_cep_select_runs_on_the_environment_device(monkeypatch):
    """The select's ``CepOperator`` takes the environment's device: with
    no card and no CPU asked for, building the job raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = pds.StreamExecutionEnvironment()
    stream = (env.from_collection(_cep_rows(n=20), timestamp_column="ts")
              .assign_timestamps_and_watermarks(0, timestamp_column="ts")
              .key_by("k"))
    CEP.pattern(stream, _followed_by(SIDES["port"])).select(
        lambda m: {"n": 1}).collect()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        env.execute()


# ---------------------------------------------------------------------------
# the DataStream cases of count_window_slide, session_windows,
# evicting_device
# ---------------------------------------------------------------------------

def test_count_window_slide_api_end_to_end():
    def run(S):
        n = 1000
        rng = np.random.default_rng(2)
        return (S["env"]().from_collection(columns={
            "k": rng.integers(0, 7, n), "v": np.ones(n)})
            .key_by("k").count_window(10, 5).sum("v")
            .execute_and_collect())
    rows = both(run)
    assert rows and all(0 < float(r["v"]) <= 10.0 for r in rows)


def test_count_window_slide_lambda_reduce_rejected_eagerly():
    for S in SIDES.values():
        ks = (S["env"]().from_collection(
            columns={"k": np.zeros(1, np.int64), "v": np.zeros(1)})
            .key_by("k"))
        with pytest.raises(ValueError, match="numpy twins"):
            ks.count_window(4, 2).reduce(lambda a, b: a + b, 0.0,
                                         value_column="v")
        with pytest.raises(ValueError, match="positive"):
            ks.count_window(4, 0).sum("v")


def test_session_end_to_end_datastream():
    def run(S):
        rows = [{"k": 1, "v": 1.0, "t": 0}, {"k": 1, "v": 2.0, "t": 4},
                {"k": 1, "v": 4.0, "t": 50}, {"k": 2, "v": 8.0, "t": 2}]
        return (S["env"]().from_collection(rows)
                .assign_timestamps_and_watermarks(0, timestamp_column="t")
                .key_by("k").window(S["win"].EventTimeSessionWindows(10))
                .sum("v").execute_and_collect())
    got = sorted((r["k"], r["window_start"], r["window_end"], r["v"])
                 for r in both(run))
    assert got == [(1, 0, 14, 3.0), (1, 50, 60, 4.0), (2, 2, 12, 8.0)]


def test_session_side_output_late_data():
    def run(S):
        env = S["env"]()
        tag = S["batch"].OutputTag("late-sessions")
        ts = np.array([100, 300, 20_000, 20_300, 50_000, 10], np.int64)
        win = (env.from_collection(columns={"k": np.zeros(6, np.int64),
                                            "v": np.ones(6), "t": ts},
                                   batch_size=2)
               .assign_timestamps_and_watermarks(0, timestamp_column="t")
               .key_by("k").window(S["win"].EventTimeSessionWindows(1000)))
        agg = win.side_output_late_data(tag).sum("v")
        late_sink = agg.get_side_output(tag).collect()
        main_sink = agg.collect()
        env.execute("late-session")
        return main_sink.rows(), late_sink.rows()
    main, late = both(run)
    assert len(late) == 1 and late[0]["t"] == 10
    assert sum(r["v"] for r in main) >= 4.0


def test_session_trigger_and_evictor_guards():
    for S in SIDES.values():
        ks = (S["env"]().from_collection(columns={"k": np.zeros(2, np.int64),
                                                  "v": np.ones(2),
                                                  "t": np.arange(2)})
              .assign_timestamps_and_watermarks(0, timestamp_column="t")
              .key_by("k"))
        with pytest.raises(ValueError, match="session"):
            (ks.window(S["win"].EventTimeSessionWindows(100))
             .trigger(S["win"].CountTrigger.of(2)).sum("v"))
        with pytest.raises(ValueError, match="session"):
            (ks.window(S["win"].EventTimeSessionWindows(100))
             .evictor(S["ev"].CountEvictor.of(2))
             .aggregate(S["fn"].CountAggregator()))


def test_evicting_device_api_routing_and_unsupported():
    def run(S):
        n = 3000
        rng = np.random.default_rng(1)
        src = (S["env"]().from_collection(columns={
            "k": rng.integers(0, 9, n), "v": rng.random(n),
            "t": np.sort(rng.integers(0, 1000, n))})
            .assign_timestamps_and_watermarks(0, timestamp_column="t"))
        ws = (src.key_by("k").window(S["win"].TumblingEventTimeWindows.of(250))
              .evictor(S["ev"].CountEvictor.of(3)))
        rows = (ws.aggregate(S["fn"].SumAggregator(S["f32"]),
                             value_column="v").execute_and_collect())
        with pytest.raises(ValueError, match="device lane"):
            (src.key_by("k").window(S["win"].TumblingEventTimeWindows.of(250))
             .evictor(S["ev"].DeltaEvictor(1.0, "v"))
             .aggregate(S["fn"].SumAggregator(S["f32"]), value_column="v"))
        with pytest.raises(ValueError, match="side outputs"):
            (src.key_by("k").window(S["win"].TumblingEventTimeWindows.of(250))
             .side_output_late_data("late")
             .evictor(S["ev"].CountEvictor.of(3))
             .aggregate(S["fn"].SumAggregator(S["f32"]), value_column="v"))
        with pytest.raises(ValueError, match="apply"):
            (src.key_by("k").window(S["win"].TumblingEventTimeWindows.of(250))
             .side_output_late_data("late").apply(lambda k, w, r: {}))
        assert not S["ed"].device_evictor_supported(
            S["ev"].DeltaEvictor(1.0, "v"), S["fn"].SumAggregator(S["f32"]))
        return [(r["k"], r["window_start"], np.float32(r["result"]).item())
                for r in rows]
    rows = both(run)
    assert rows and all(r[2] <= 3.0 for r in rows)


def test_evicting_device_count_and_session_guard():
    def run(S):
        n = 2000
        rng = np.random.default_rng(4)
        src = (S["env"]().from_collection(columns={
            "k": rng.integers(0, 5, n), "v": rng.random(n),
            "t": np.sort(rng.integers(0, 1000, n))})
            .assign_timestamps_and_watermarks(0, timestamp_column="t"))
        return (src.key_by("k").window(S["win"].TumblingEventTimeWindows.of(500))
                .evictor(S["ev"].CountEvictor.of(7))
                .aggregate(S["fn"].CountAggregator()).execute_and_collect())
    rows = both(run)
    assert rows and all(int(r["result"]) <= 7 for r in rows)


def test_evictor_apply_and_aggregate_land_on_their_lanes():
    """``.evictor(...).sum`` lands on the device lane, ``.evictor(...)
    .apply(fn)`` on the host lane, in both packages."""
    for name, S in SIDES.items():
        env = S["env"]()
        ws = (env.from_collection(columns={"k": np.zeros(3, np.int64),
                                           "v": np.ones(3),
                                           "t": np.arange(3)})
              .assign_timestamps_and_watermarks(0, timestamp_column="t")
              .key_by("k").window(S["win"].TumblingEventTimeWindows.of(10))
              .evictor(S["ev"].CountEvictor.of(1)))
        dev = ws.aggregate(S["fn"].SumAggregator(S["f32"]),
                           value_column="v").transformation
        host = ws.apply(lambda k, w, rows: {"n": len(rows)}).transformation
        assert type(dev.operator_factory()).__name__ == \
            "DeviceEvictingWindowOperator", name
        assert type(host.operator_factory()).__name__ == \
            "EvictingWindowOperator", name

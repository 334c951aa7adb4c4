"""Port parity for the basic operators: ``flink_tpu_torch.operators.basic``
and ``flink_tpu_torch.operators.count_window`` against ``flink_tpu``'s on
the CPU, on numpy-seeded batches.

``KeyedReduceOperator`` runs ``segment_running_fold`` as its device step on
both sides, on batches padded alike, so every record's running value is
compared BIT FOR BIT, across key growth past ``initial_key_capacity``, batch
lengths that are not powers of two, and snapshots restored across the
packages both ways.  The host operators (map/filter/flatMap, keyBy,
timestamps and watermarks, side outputs, sinks, ``ExtremumByOperator``,
``CountSlideWindowOperator``) are numpy on both sides and are compared
exactly: columns, timestamps, key groups, watermarks and snapshots.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_tpu.core import functions as jfn
from flink_tpu.core import watermarks as jwm
from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.core.batch import Watermark as JaxWatermark
from flink_tpu.operators import basic as jbasic
from flink_tpu.operators.count_window import \
    CountSlideWindowOperator as JaxCountSlide
from flink_tpu_torch.core import batch as pbatch
from flink_tpu_torch.core import functions as pfn
from flink_tpu_torch.core import watermarks as pwm
from flink_tpu_torch.core.batch import RecordBatch, Watermark
from flink_tpu_torch.interop import (keyed_snapshot_from_jax,
                                     keyed_snapshot_to_jax)
from flink_tpu_torch.operators import basic as pbasic
from flink_tpu_torch.operators.count_window import CountSlideWindowOperator

SIDES = {
    "jax": dict(fn=jfn, wm=jwm, basic=jbasic, RB=JaxBatch, WM=JaxWatermark,
                CountSlide=JaxCountSlide, f32=jnp.float32, kw={}),
    "port": dict(fn=pfn, wm=pwm, basic=pbasic, RB=RecordBatch, WM=Watermark,
                 CountSlide=CountSlideWindowOperator, f32="float32",
                 kw={"device": "cpu"}),
}


def _bits(a):
    a = np.asarray(a)
    return a.dtype.str, a.shape, a.tobytes()


def _batch_view(b):
    """Every column's bits, the timestamps, key ids and key groups."""
    meta = tuple(None if a is None else _bits(a)
                 for a in (b.timestamps, b.key_ids, b.key_groups))
    return tuple((c, _bits(b.column(c))) for c in sorted(b.columns)), meta


def _views(out):
    return [_batch_view(e) if hasattr(e, "columns")
            else ("wm", e.timestamp) for e in out]


# ---------------------------------------------------------------------------
# KeyedReduceOperator
# ---------------------------------------------------------------------------

AGGS = {
    "sum": lambda S: S["fn"].SumAggregator(S["f32"]),
    "max": lambda S: S["fn"].MaxAggregator(S["f32"]),
    "avg": lambda S: S["fn"].AvgAggregator(S["f32"]),
    "lambda": lambda S: S["fn"].LambdaReduce(lambda a, b: a + b,
                                             np.float32(0.0)),
    "tuple": lambda S: S["fn"].TupleAggregator(
        {"s": ("v", S["fn"].SumAggregator(S["f32"])),
         "m": ("v", S["fn"].MinAggregator(S["f32"])),
         "n": ("v", S["fn"].CountAggregator())}),
}
SIZES = (1000, 37, 1, 64, 700, 1500, 3, 999)


def _reduce_batches(seed=5):
    """Batch lengths that are mostly not powers of two; the key range
    widens past 1024 (the initial capacity), values include -0.0 and
    float64 columns (narrowed to 32 bits as JAX narrows them)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, B in enumerate(SIZES):
        keys = rng.integers(0, 300 + 400 * i, B).astype(np.int64)
        vals = rng.standard_normal(B) * 10
        vals[rng.random(B) < 0.05] = -0.0
        out.append((keys, vals.astype(np.float64 if i % 2 else np.float32),
                    np.arange(B, dtype=np.int64) + 1000 * i))
    return out


REDUCE_BATCHES = _reduce_batches()


def _reduce_op(side, agg):
    S = SIDES[side]
    op = S["basic"].KeyedReduceOperator(
        AGGS[agg](S), key_column="k",
        value_column=None if agg == "tuple" else "v", **S["kw"])
    op.open(S["fn"].RuntimeContext())
    return op


def _reduce_drive(side, op, batches):
    RB = SIDES[side]["RB"]
    return [_views(op.process_batch(RB({"k": k, "v": v}, timestamps=ts)))
            for k, v, ts in batches]


@pytest.mark.parametrize("agg", list(AGGS))
def test_keyed_reduce_running_outputs_bit_equal_jax(agg):
    jop = _reduce_op("jax", agg)
    pop = _reduce_op("port", agg)
    want = _reduce_drive("jax", jop, REDUCE_BATCHES)
    got = _reduce_drive("port", pop, REDUCE_BATCHES)
    assert got == want
    assert pop._K == jop._K > 1024          # grew past the initial capacity
    js, ps = keyed_snapshot_from_jax(jop.snapshot_state()), \
        pop.snapshot_state()
    assert ps["key_index_kind"] == js["key_index_kind"] == "KeyIndex"
    assert np.array_equal(ps["keys"]["reverse"], js["keys"]["reverse"])
    for a, b in zip(ps["leaves"], js["leaves"], strict=True):
        assert _bits(a) == _bits(b)


@pytest.mark.parametrize("agg", ["sum", "lambda", "avg"])
def test_keyed_reduce_snapshot_restores_across_packages(agg):
    """Half the batches, a snapshot, the other half in a restored operator
    of the OTHER package: every running value as one unbroken run."""
    half = len(REDUCE_BATCHES) // 2
    want = _reduce_drive("jax", _reduce_op("jax", agg), REDUCE_BATCHES)
    for writer, reader, conv in (("jax", "port", keyed_snapshot_from_jax),
                                 ("port", "jax", keyed_snapshot_to_jax)):
        w = _reduce_op(writer, agg)
        first = _reduce_drive(writer, w, REDUCE_BATCHES[:half])
        r = _reduce_op(reader, agg)
        r.restore_state(conv(w.snapshot_state()))
        second = _reduce_drive(reader, r, REDUCE_BATCHES[half:])
        assert first + second == want, (writer, reader)


def test_keyed_reduce_snapshot_is_a_copy():
    """A snapshot holds the state of its moment: later batches do not write
    through it (on the CPU a tensor's ``.cpu()`` is the tensor itself)."""
    op = _reduce_op("port", "sum")
    _reduce_drive("port", op, REDUCE_BATCHES[:2])
    snap = op.snapshot_state()
    before = [l.copy() for l in snap["leaves"]]
    _reduce_drive("port", op, REDUCE_BATCHES[2:4])
    for a, b in zip(snap["leaves"], before, strict=True):
        assert _bits(a) == _bits(b)


@pytest.mark.parametrize("agg", ["sum", "tuple"])
def test_keyed_reduce_takes_the_c_keydict_as_jax_does(agg):
    """The keyed reduce's index is ``make_key_index``'s, as JAX's is: the
    port's C keydict (JAX's ``KeyIndex`` binds its own C keydict when its
    native library loads).  Slot ids, running values and snapshots are
    unchanged: bit for bit against JAX, and a restore takes the C keydict
    again."""
    from flink_tpu_torch.state.keyindex import NativeKeyIndex, make_key_index
    jop, pop = _reduce_op("jax", agg), _reduce_op("port", agg)
    assert _reduce_drive("port", pop, REDUCE_BATCHES[:3]) \
        == _reduce_drive("jax", jop, REDUCE_BATCHES[:3])
    assert isinstance(pop.key_index, NativeKeyIndex)
    assert np.array_equal(pop.key_index.reverse_keys(),
                          jop.key_index.reverse_keys())
    snap = pop.snapshot_state()
    assert snap["key_index_kind"] == "KeyIndex"
    back = _reduce_op("port", agg)
    back.restore_state(snap)
    assert isinstance(back.key_index, NativeKeyIndex)
    assert _reduce_drive("port", back, REDUCE_BATCHES[3:]) \
        == _reduce_drive("jax", jop, REDUCE_BATCHES[3:])
    hinted = make_key_index(np.int64(7), capacity_hint=1 << 20)
    assert isinstance(hinted, NativeKeyIndex) and hinted.num_keys == 0
    with pytest.raises(NotImplementedError, match="object-key slice"):
        make_key_index("a")
    with pytest.raises(NotImplementedError, match="object-key slice"):
        make_key_index(np.asarray([1, 2]))    # a composite key


def test_keyed_reduce_pads_like_jax_and_refuses_object_keys():
    op = _reduce_op("port", "sum")
    assert op._K == 1024 and op.device == torch.device("cpu")
    assert op.snapshot_state() == {"empty": True}
    with pytest.raises(NotImplementedError, match="object-key slice"):
        op.process_batch(RecordBatch({"k": np.array(["a", "b"], object),
                                      "v": np.ones(2, np.float32)}))


# ---------------------------------------------------------------------------
# the stateless operators, keyBy, timestamps and watermarks
# ---------------------------------------------------------------------------

def _host_batch(side, seed=3, n=50):
    rng = np.random.default_rng(seed)
    RB = SIDES[side]["RB"]
    return RB({"k": rng.integers(0, 9, n).astype(np.int64),
               "v": rng.standard_normal(n).astype(np.float32)},
              timestamps=rng.integers(0, 1000, n).astype(np.int64),
              key_ids=np.arange(n, dtype=np.int32),
              key_groups=np.arange(n, dtype=np.int32) % 7)


STATELESS = {
    "map": lambda B: B.MapOperator(
        lambda c: {"k": c["k"], "w": c["v"] * np.float32(2)}),
    "filter": lambda B: B.FilterOperator(lambda c: c["v"] > 0),
    "filter-all": lambda B: B.FilterOperator(lambda c: c["v"] == c["v"]),
    "flat-map": lambda B: B.FlatMapOperator(
        lambda c: ({"k": np.repeat(c["k"], 2)},
                   np.repeat(np.arange(len(c["k"])), 2))),
    "key-by": lambda B: B.KeyByOperator("k", max_parallelism=128),
}


@pytest.mark.parametrize("name", list(STATELESS))
def test_stateless_operators_equal_jax(name):
    outs = {}
    for side, S in SIDES.items():
        op = STATELESS[name](S["basic"])
        assert op.is_stateless and op.forwards_watermarks
        outs[side] = _views(op.process_batch(_host_batch(side)))
    assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("keys", [
    np.arange(-500, 500, 7, dtype=np.int64),
    np.array(["alpha", "beta", "", "key-42", "ünïcode"], object)])
def test_key_by_key_groups_equal_jax(keys):
    got = {}
    for side, S in SIDES.items():
        op = S["basic"].KeyByOperator("k", max_parallelism=4096)
        (b,) = op.process_batch(S["RB"]({"k": keys}))
        got[side] = np.asarray(b.key_groups)
    assert got["port"].dtype == got["jax"].dtype
    assert np.array_equal(got["port"], got["jax"])


GENERATORS = {
    "bounded": lambda W: W.BoundedOutOfOrdernessWatermarks(25),
    "monotonous": lambda W: W.MonotonousTimestampsWatermarks(),
    "none": lambda W: W.NoWatermarks(),
}


@pytest.mark.parametrize("gen", list(GENERATORS))
def test_timestamps_and_watermarks_equal_jax(gen):
    rng = np.random.default_rng(11)
    feeds = [rng.integers(0, 500 * (i + 1), 40).astype(np.int64)
             for i in range(5)]
    outs = {}
    for side, S in SIDES.items():
        op = S["basic"].TimestampsAndWatermarksOperator(
            GENERATORS[gen](S["wm"]), timestamp_column="t")
        assert not op.forwards_watermarks
        out = []
        for i, t in enumerate(feeds):
            if i == 3:      # the generator's state survives a restore
                snap = op.snapshot_state()
                op = S["basic"].TimestampsAndWatermarksOperator(
                    GENERATORS[gen](S["wm"]), timestamp_column="t")
                op.restore_state(snap)
            out += op.process_batch(S["RB"]({"t": t, "x": t * 2}))
        out += op.process_watermark(S["WM"](10))
        out += op.process_watermark(S["WM"](2 ** 63 - 1))
        outs[side] = (_views(out), op.generator.on_periodic())
    assert outs["port"] == outs["jax"]
    assert pbatch.MAX_WATERMARK == 2 ** 63 - 1


def test_watermark_strategies_equal_jax():
    cols = {"t": np.array([5, 3, 9], np.int64)}
    for name in ("for_monotonous_timestamps", "no_watermarks"):
        j = getattr(jwm.WatermarkStrategy, name)()
        p = getattr(pwm.WatermarkStrategy, name)()
        assert (type(p.generator_factory()).__name__
                == type(j.generator_factory()).__name__)
    j = jwm.WatermarkStrategy.for_bounded_out_of_orderness(4) \
        .with_timestamp_assigner("t")
    p = pwm.WatermarkStrategy.for_bounded_out_of_orderness(4) \
        .with_timestamp_assigner("t")
    assert np.array_equal(p.extract_timestamps(cols),
                          j.extract_timestamps(cols))
    assert (p.generator_factory().on_batch(cols["t"])
            == j.generator_factory().on_batch(cols["t"]))


# ---------------------------------------------------------------------------
# side outputs and sinks
# ---------------------------------------------------------------------------

def test_side_output_takes_only_its_tag():
    for side, S in SIDES.items():
        op = S["basic"].SideOutputOperator("late")
        b = _host_batch(side)
        assert op.accepts_tag == "late"
        assert op.process_batch(b) == []
        assert op.process_tagged(b) == [b]
    assert pbatch.TaggedBatch("late", None).tag == "late"
    assert pbatch.OutputTag("late").name == "late"


class _ListSink:
    def __init__(self):
        self.rows, self.events = [], []

    def write_batch(self, batch):
        self.rows += batch.to_rows()

    def on_watermark(self, ts):
        self.events.append(("wm", ts))

    def flush(self):
        self.events.append(("flush",))

    def snapshot_state(self):
        return {"n": len(self.rows)}

    def restore_state(self, snap):
        self.events.append(("restore", snap["n"]))

    def notify_checkpoint_complete(self, cid):
        self.events.append(("commit", cid))

    def close(self):
        self.events.append(("close",))


def test_sink_operator_lifecycle_equal_jax():
    seen = {}
    for side, S in SIDES.items():
        sink = _ListSink()
        op = S["basic"].SinkOperator(sink)
        op.open(S["fn"].RuntimeContext())
        assert op.process_batch(_host_batch(side)) == []
        assert op.process_watermark(S["WM"](77)) == []
        assert op.end_input() == []
        snap = op.snapshot_state()
        op.restore_state(snap)
        op.notify_checkpoint_complete(3)
        op.close()
        seen[side] = (sink.rows, sink.events, snap)
    assert seen["port"] == seen["jax"]


def test_sink_latency_marker_waits_for_the_clock_seam():
    op = pbasic.SinkOperator(_ListSink())
    with pytest.raises(NotImplementedError, match="runtime-stack slice"):
        op.on_latency_marker(object())


# ---------------------------------------------------------------------------
# ExtremumByOperator
# ---------------------------------------------------------------------------

def _extremum_batches(seed=9):
    """Integer-valued floats (ties), NaN rows, keys repeating across
    batches."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(6):
        n = 40
        v = rng.integers(0, 5, n).astype(np.float64)
        v[rng.random(n) < 0.15] = np.nan
        if i == 4:
            v[:] = np.nan                   # an all-NaN batch emits nothing
        out.append(({"k": rng.integers(0, 6, n).astype(np.int64), "v": v,
                     "tag": np.arange(n, dtype=np.int64) + 100 * i},
                    np.arange(n, dtype=np.int64) + 1000 * i))
    return out


@pytest.mark.parametrize("is_min", [True, False])
def test_extremum_by_equal_jax_with_ties_and_nan(is_min):
    batches = _extremum_batches()
    outs, snaps = {}, {}
    for side, S in SIDES.items():
        op = S["basic"].ExtremumByOperator("k", "v", is_min=is_min)
        out = []
        for i, (cols, ts) in enumerate(batches):
            if i == 3:
                snaps[side] = op.snapshot_state()
            out += op.process_batch(S["RB"](cols, timestamps=ts))
        outs[side] = _views(out)
    assert outs["port"] == outs["jax"]
    p = keyed_snapshot_from_jax(snaps["jax"])
    assert np.array_equal(p["keys"]["reverse"],
                          snaps["port"]["keys"]["reverse"])
    assert _bits(p["state.vals"]) == _bits(snaps["port"]["state.vals"])
    assert list(p["state.rows"]) == list(snaps["port"]["state.rows"])
    # the JAX snapshot restores into the port, which goes on as JAX did
    op = pbasic.ExtremumByOperator("k", "v", is_min=is_min)
    op.restore_state(p)
    jop = jbasic.ExtremumByOperator("k", "v", is_min=is_min)
    jop.restore_state(keyed_snapshot_to_jax(snaps["port"]))
    for cols, ts in batches[3:]:
        assert (_views(op.process_batch(RecordBatch(cols, timestamps=ts)))
                == _views(jop.process_batch(JaxBatch(cols, timestamps=ts))))


# ---------------------------------------------------------------------------
# CountSlideWindowOperator (the cases of tests/test_count_window_slide.py)
# ---------------------------------------------------------------------------

SLIDE_AGGS = {
    "sum": lambda S: S["fn"].SumAggregator(np.float64),
    "avg": lambda S: S["fn"].AvgAggregator(np.float32),
    "max": lambda S: S["fn"].MaxAggregator(np.float64),
}


def _slide_run(side, agg, size, slide, feeds, snap_at=None):
    S = SIDES[side]
    mk = lambda: S["CountSlide"](SLIDE_AGGS[agg](S), key_column="k",  # noqa
                                 value_column="v", size=size, slide=slide)
    op = mk()
    op.open(S["fn"].RuntimeContext())
    out = []
    for i, (k, v) in enumerate(feeds):
        if i == snap_at:
            snap = op.snapshot_state()
            op = mk()
            op.restore_state(snap)
        out.append(_views(op.process_batch(S["RB"](
            {"k": np.asarray(k, np.int64), "v": np.asarray(v, np.float64)}))))
    out.append(_views(op.process_watermark(S["WM"](5))))
    out.append(_views(op.end_input()))
    return out, op.snapshot_state()


def _slide_feeds():
    rng = np.random.default_rng(5)
    keys, vals = rng.integers(0, 10, 500), rng.random(500)
    return {
        "every-slide": ("sum", 4, 2, [([1], [v]) for v in range(1, 7)]),
        "ring-laps": ("sum", 3, 7, [([1] * 7, [1, 2, 3, 4, 5, 6, 7])]),
        "vectorized": ("sum", 5, 5, [(keys[lo:lo + 50], vals[lo:lo + 50])
                                     for lo in range(0, 500, 50)]),
        "avg": ("avg", 3, 3, [([2] * 3, [3, 6, 9])]),
        "max": ("max", 2, 2, [([1] * 2, [5, 1]), ([1] * 2, [2, 3])]),
        "max-coalesced": ("max", 2, 2, [([1] * 4, [5, 1, 2, 3])]),
        "restore": ("sum", 4, 2, [([1, 1, 1], [1, 2, 3]), ([1], [4])]),
    }


@pytest.mark.parametrize("case", list(_slide_feeds()))
def test_count_slide_window_equal_jax(case):
    agg, size, slide, feeds = _slide_feeds()[case]
    snap_at = 1 if case == "restore" else None
    got, psnap = _slide_run("port", agg, size, slide, feeds, snap_at)
    want, jsnap = _slide_run("jax", agg, size, slide, feeds, snap_at)
    assert got == want and any(got)
    assert np.array_equal(psnap["key_index"]["reverse"],
                          jsnap["key_index"]["reverse"])
    for f in ("ring", "count", "fired"):
        assert _bits(psnap[f]) == _bits(jsnap[f])


def test_count_slide_window_validates_like_jax():
    for side, S in SIDES.items():
        with pytest.raises(ValueError, match="numpy twins"):
            S["CountSlide"](S["fn"].LambdaReduce(lambda a, b: a + b, 0.0),
                            key_column="k", value_column="v", size=3,
                            slide=1)
        with pytest.raises(ValueError, match="positive"):
            S["CountSlide"](S["fn"].SumAggregator(np.float64),
                            key_column="k", value_column="v", size=3,
                            slide=0)


def test_lambda_reduce_declares_no_kinds_and_no_host_twins():
    agg = pfn.LambdaReduce(lambda a, b: a * b, 1)
    assert agg.scatter_kind_leaves() is None
    assert not agg.supports_host_emit() and not agg.supports_retraction()
    # a Python int identity is int32, as JAX stores it with x64 off
    assert agg.acc_spec().leaf_dtypes == (np.dtype(np.int32),)
    assert pfn.AvgAggregator().supports_retraction()
    assert not pfn.MaxAggregator().supports_retraction()
    assert isinstance(agg, pfn.Function)

"""Port parity for slice 4: the C host layer of ``flink_tpu_torch`` (the
keydict and the window value mirror, ``csrc/host_mirror.cc``) against the JAX
operator's ``native_emit=True`` lane, which runs the JAX package's own
``native/flink_native.cc``.

Both sides run the host emit tier with pinned values only: ``native_shards``
(never JAX's measured auto), ``device_probe``, ``device_sync`` and
``superbatch``.  The JAX side runs under the ``_jax_x64`` shim (its probe lane
imports ``jax.experimental.enable_x64``, which jax 0.9 moved).

The first part ports the nine cases of ``tests/test_native_mirror.py``: each
runs the port's native lane, the JAX native lane and the port's numpy lane on
the same seeded input.  Fires are compared bit for bit: on the CPU both
packages fold the device delta in row order and the C mirror folds in row
order, so the bits agree (``_assert_fires_equal`` also holds them to
rtol 1e-6 per key, the stated tolerance, which is what it would fall back to
on a card, whose delta fold is unordered).  The second part covers the
lanes, the shard counts on both sides of the C pass's parallel threshold
(2^14 rows), the keydict's slot numbering, snapshots across packages and
mirrors, and a failed build.
"""

import contextlib
import ctypes
import shutil

import numpy as np
import pytest

import jax
import jax.experimental
import jax.numpy as jnp

from flink_tpu.core import functions as jfn
from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.core.batch import Watermark as JaxWatermark
from flink_tpu.operators.window_agg import WindowAggOperator as JaxOp
from flink_tpu.state.keyindex import KeyIndex as JaxKeyIndex
from flink_tpu.windowing import assigners as jwin
from flink_tpu_torch.core import functions as pfn
from flink_tpu_torch.core.batch import RecordBatch, Watermark
from flink_tpu_torch.interop import snapshot_from_jax, snapshot_to_jax
from flink_tpu_torch.kernels import build
from flink_tpu_torch.operators.window_agg import WindowAggOperator
from flink_tpu_torch.state.keyindex import KeyIndex, NativeKeyIndex
from flink_tpu_torch.state.native_mirror import NativeWindowMirror
from flink_tpu_torch.windowing import assigners as pwin

RTOL = ATOL = 1e-6
#: the C pass goes parallel from this many rows (WM_MIN_PARALLEL)
MIN_PARALLEL = 1 << 14
#: the nine spec cases run path 1's lane: scatter sync, probe on, one batch
#: at a time
SPEC_LANE = dict(device_sync="scatter", device_probe="on", superbatch=1)


@contextlib.contextmanager
def _jax_x64():
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64",
                       lambda new_val=True: jax.enable_x64(new_val),
                       raising=False)
        yield


#: (id, JAX aggregate, port aggregate), as in tests/test_native_mirror.py
AGGS = {
    "sum": (lambda: jfn.SumAggregator(jnp.float32),
            lambda: pfn.SumAggregator()),
    "min": (lambda: jfn.MinAggregator(jnp.float32),
            lambda: pfn.MinAggregator()),
    "max": (lambda: jfn.MaxAggregator(jnp.float32),
            lambda: pfn.MaxAggregator()),
    "count": (lambda: jfn.CountAggregator(), lambda: pfn.CountAggregator()),
    "avg": (lambda: jfn.AvgAggregator(jnp.float32),
            lambda: pfn.AvgAggregator()),
    "tuple": (lambda: jfn.TupleAggregator(
                  {"s": ("v", jfn.SumAggregator(jnp.float32)),
                   "m": ("v", jfn.MaxAggregator(jnp.float32))}),
              lambda: pfn.TupleAggregator(
                  {"s": ("v", pfn.SumAggregator()),
                   "m": ("v", pfn.MaxAggregator())})),
}


def _assigner(side, sliding=None):
    mod = jwin if side == "jax" else pwin
    if sliding is None:
        return mod.TumblingEventTimeWindows.of(100)
    return mod.SlidingEventTimeWindows.of(*sliding)


class _Side:
    """One operator of either package, driven through the same calls."""

    def __init__(self, side, agg="sum", sliding=None, native=True, shards=1,
                 lane=SPEC_LANE, **kw):
        self.side = side
        jagg, pagg = AGGS[agg]
        a = jagg() if side == "jax" else pagg()
        vcol = None if agg == "tuple" else "v"
        common = dict(key_column="k", value_column=vcol, emit_tier="host",
                      snapshot_source="mirror", native_emit=native,
                      native_shards=shards if native else 0,
                      pipeline_depth=0, **lane, **kw)
        if side == "jax":
            self.RB, self.WM = JaxBatch, JaxWatermark
            with self.ctx():
                self.op = JaxOp(_assigner(side, sliding), a, **common)
                self.op.open(jfn.RuntimeContext())
        else:
            self.RB, self.WM = RecordBatch, Watermark
            self.op = WindowAggOperator(_assigner(side, sliding), a,
                                        device="cpu", **common)
            self.op.open(pfn.RuntimeContext())

    def ctx(self):
        return _jax_x64() if self.side == "jax" else contextlib.nullcontext()

    @property
    def native_active(self):
        return (self.op._nm is not None if self.side == "jax"
                else self.op.native_mirror_active)

    def feed(self, keys, vals, ts, wm=None):
        with self.ctx():
            out = self.op.process_batch(self.RB(
                {"k": np.asarray(keys, np.int64),
                 "v": np.asarray(vals, np.float32)},
                timestamps=np.asarray(ts, np.int64)))
            if wm is not None:
                out += self.op.process_watermark(self.WM(wm))
        return out

    def call(self, name, *args):
        with self.ctx():
            return getattr(self.op, name)(*args)


def _result_cols(b):
    return sorted(c for c in b.columns if c not in ("k", "window_start",
                                                    "window_end"))


def _digests(outs):
    """(window start, end, keys' bytes, each result column's bytes) per
    fired batch: the bit-for-bit view."""
    return [(int(np.asarray(b.column("window_start"))[0]),
             int(np.asarray(b.column("window_end"))[0]),
             np.asarray(b.column("k")).tobytes(),
             tuple((c, np.asarray(b.column(c)).dtype.str,
                    np.asarray(b.column(c)).tobytes())
                   for c in _result_cols(b)))
            for b in outs if len(b)]


def _assert_fires_equal(got, want, bits=True):
    """Per window, sorted by key: same keys, results to rtol 1e-6, then
    (``bits``) the same bits."""
    gb = [b for b in got if len(b)]
    wb = [b for b in want if len(b)]
    assert [int(np.asarray(b.column("window_start"))[0]) for b in gb] == \
        [int(np.asarray(b.column("window_start"))[0]) for b in wb]
    for g, w in zip(gb, wb):
        gk, wk = np.asarray(g.column("k")), np.asarray(w.column("k"))
        go, wo = np.argsort(gk, kind="stable"), np.argsort(wk, kind="stable")
        assert np.array_equal(gk[go], wk[wo])
        assert _result_cols(g) == _result_cols(w)
        for c in _result_cols(g):
            gr, wr = np.asarray(g.column(c)), np.asarray(w.column(c))
            assert gr.dtype == wr.dtype, c
            np.testing.assert_allclose(gr[go], wr[wo], rtol=RTOL, atol=ATOL)
    if bits:
        assert _digests(gb) == _digests(wb)


def _random_run(s, seed=0, n_batches=6, n_keys=500, bsz=1000):
    rng = np.random.default_rng(seed)
    out = []
    t = 0
    for _ in range(n_batches):
        keys = rng.integers(0, n_keys, bsz)
        vals = rng.random(bsz).astype(np.float32)
        ts = t + np.sort(rng.integers(0, 120, bsz))
        t += 120
        out += s.feed(keys, vals, ts, wm=int(ts.max()) - 1)
    return out + s.call("end_input")


def _three(**kw):
    """The port's native lane, the JAX native lane, the port's numpy lane."""
    return (_Side("port", **kw), _Side("jax", **kw),
            _Side("port", native=False, **kw))


# ---------------------------------------------------------------------------
# the nine cases of tests/test_native_mirror.py, against the JAX operator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("agg", list(AGGS))
def test_fire_equivalence_tumbling(agg):
    port, ref, numpy_lane = _three(agg=agg)
    assert not port.native_active          # binds on the first batch
    got = _random_run(port)
    assert port.native_active, "the C mirror did not engage"
    want = _random_run(ref)
    assert ref.native_active
    _assert_fires_equal(got, want)
    _assert_fires_equal(got, _random_run(numpy_lane))
    assert not numpy_lane.native_active


@pytest.mark.parametrize("agg", ["sum", "avg", "min"])
def test_fire_equivalence_sliding_panes(agg):
    port, ref, numpy_lane = _three(agg=agg, sliding=(300, 100))
    got = _random_run(port)
    _assert_fires_equal(got, _random_run(ref))
    _assert_fires_equal(got, _random_run(numpy_lane))
    assert port.native_active


def test_wide_window_many_panes():
    """A window of 100 panes combines every one of them in the C fire."""
    outs = []
    for s in _three(sliding=(1000, 10)):
        out = []
        for i in range(100):
            out += s.feed([1], [1.0], [i * 10 + 5])
        out += s.call("process_watermark", s.WM(999))
        outs.append(out)
    _assert_fires_equal(outs[0], outs[1])
    _assert_fires_equal(outs[0], outs[2])
    full = [b for b in outs[0]
            if int(np.asarray(b.column("window_start"))[0]) == 0]
    assert float(np.asarray(full[0].column("result"))[0]) == 100.0


def test_key_capacity_growth():
    """Far past the initial capacity (64 keys) fires stay exact."""
    sides = _three(initial_key_capacity=64)
    outs = [_random_run(s, n_keys=5000, bsz=2000) for s in sides]
    _assert_fires_equal(outs[0], outs[1])
    _assert_fires_equal(outs[0], outs[2])
    assert sides[0].op.key_index.num_keys > 64
    assert sides[0].op._K >= sides[0].op.key_index.num_keys


def test_lateness_refire_equivalence():
    outs = []
    for s in _three(allowed_lateness_ms=100):
        out = s.feed([1, 2], [1.0, 2.0], [10, 20], wm=99)   # fires window 0
        out += s.feed([1], [5.0], [30], wm=150)             # late: re-fires
        out += s.call("process_watermark", s.WM(210))       # past cleanup
        out += s.feed([1], [9.0], [15])                     # dropped
        out += s.call("end_input")
        outs.append(out)
        assert s.op.late_dropped == 1
    _assert_fires_equal(outs[0], outs[1])
    _assert_fires_equal(outs[0], outs[2])


def _snap_source(side, native):
    s = _Side(side, native=native)
    s.feed([1, 2, 3], [1.0, 2.0, 3.0], [10, 20, 30], wm=50)
    s.feed([1, 4], [10.0, 4.0], [60, 130])
    snap = s.call("snapshot_state")
    return s, (snapshot_from_jax(snap) if side == "jax" else snap)


def _tail(s):
    return s.feed([2], [7.0], [140], wm=2000) + s.call("end_input")


@pytest.mark.parametrize("src,dst", [
    (("port", True), ("port", False)), (("port", False), ("port", True)),
    (("port", True), ("jax", True)), (("jax", True), ("port", True)),
    (("jax", False), ("port", True)), (("port", True), ("jax", False))],
    ids=lambda x: f"{x[0]}-{'native' if x[1] else 'numpy'}")
def test_snapshot_restore_cross_implementation(src, dst):
    """A snapshot from either mirror of either package restores into the
    other: the format does not depend on which mirror wrote it."""
    s, snap = _snap_source(*src)
    d = _Side(dst[0], native=dst[1])
    d.call("restore_state", snap if dst[0] == "port" else snapshot_to_jax(snap))
    assert d.native_active == dst[1]
    _assert_fires_equal(_tail(d), _tail(s))


def test_pane_expiry_drops_native_state():
    s = _Side("port")
    s.feed([1], [1.0], [10], wm=99)
    s.feed([1], [1.0], [110], wm=199)
    assert s.native_active
    assert 0 not in s.op._nm.live_panes().tolist()
    assert s.op._nm.live_panes().tolist() == []     # pane 1 fired too


def test_device_mirror_consistency_native():
    s = _Side("port")
    _random_run(s, n_batches=3)
    assert s.native_active
    assert s.op.verify_mirror()


def test_reset_state_unbinds():
    s = _Side("port")
    s.feed([1], [1.0], [10])
    first = s.op._nm
    assert first is not None
    s.op.reset_state()
    assert not s.native_active and s.op.key_index is None
    out = s.feed([2], [2.0], [10], wm=99)
    assert s.native_active and s.op._nm is not first   # a fresh keydict
    assert np.asarray(out[0].column("k")).tolist() == [2]


# ---------------------------------------------------------------------------
# the lanes: {probe off, on} x {scatter, deferred} x superbatch {1, 4}
# ---------------------------------------------------------------------------

def _batches(n_batches=12, nk=1500, b=4000, seed=11):
    """``tests/test_torch_fused_step.py``'s stream: window 100, key growth
    from 1 << 10, a snapshot after batch 6."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        keys = rng.integers(0, nk, b).astype(np.int64)
        vals = rng.random(b).astype(np.float32)
        ts = i * 50 + np.sort(rng.integers(0, 50, b)).astype(np.int64)
        out.append((keys, vals, ts))
    return out


BATCHES = _batches()
SNAP_AT = 6
LANES = {f"{probe}-{sync}-sb{sb}": dict(device_probe=probe, device_sync=sync,
                                        superbatch=sb)
         for probe in ("off", "on") for sync in ("scatter", "deferred")
         for sb in (1, 4)}


def _drive(s, batches, snap_at=None, end=True):
    out, snap = [], None
    for i, (keys, vals, ts) in enumerate(batches):
        out += s.feed(keys, vals, ts, wm=int(ts.max()) - 1)
        if i == snap_at:
            s.call("prepare_snapshot_pre_barrier")
            snap = s.call("snapshot_state")
    return out + (s.call("end_input") if end else []), snap


def _snap_bytes(snap):
    return (np.asarray(snap["panes"]).tobytes(), snap["counts"].tobytes(),
            tuple(np.asarray(l).tobytes() for l in snap["leaves"]),
            np.asarray(snap["key_index"]["reverse"]).tobytes())


def _counters(op):
    s, f = op.device_probe_stats(), op.fused_stats()
    return (op.late_dropped, op.key_index.num_keys, op.watermark,
            op.last_fired_window, s["probe_hits"], s["probe_misses"],
            f["staged_batches"], f["flushes"], f["scan_dispatches"],
            f["scan_steps"], f["host_super_passes"])


@pytest.fixture(scope="module")
def lane_runs():
    runs = {}
    for name, lane in LANES.items():
        for side, native in (("port", True), ("jax", True), ("port", False)):
            s = _Side(side, native=native, shards=4, lane=lane,
                      initial_key_capacity=1 << 10)
            out, snap = _drive(s, BATCHES, SNAP_AT)
            if side == "port":
                assert s.op.verify_mirror()
                assert s.native_active == native
                phases = set(s.op.phase_ns)
            else:
                snap = snapshot_from_jax(snap)
                phases = None
            runs[(name, side, native)] = (out, snap, _counters(s.op), phases)
    return runs


@pytest.mark.parametrize("lane", list(LANES))
def test_lane_equals_jax_native(lane, lane_runs):
    """Fires, snapshots and counters of the port's native lane equal the JAX
    native lane's, bit for bit."""
    got, want = lane_runs[(lane, "port", True)], lane_runs[(lane, "jax", True)]
    _assert_fires_equal(got[0], want[0])
    assert _snap_bytes(got[1]) == _snap_bytes(want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("lane", list(LANES))
def test_lane_equals_numpy_mirror(lane, lane_runs):
    """The C mirror changes no result of the port: fires, snapshots and
    counters equal the numpy mirror's.  Phases: the C pass is
    ``probe_mirror``; there is no ``mirror`` (nor ``probe``) phase."""
    got, want = lane_runs[(lane, "port", True)], lane_runs[(lane, "port", False)]
    _assert_fires_equal(got[0], want[0])
    assert _snap_bytes(got[1]) == _snap_bytes(want[1])
    assert got[2] == want[2]
    assert "probe_mirror" in got[3]
    assert not {"mirror", "probe"} & got[3]
    assert "mirror" in want[3]


def test_fused_native_miss_pass_is_one_c_call(monkeypatch):
    """Under the fused lane a flush's miss rows take ONE C pass over the
    concatenated block, and its slots are those of one pass per batch (the
    lane tests hold the results equal to JAX's pass per step)."""
    calls = []
    real = NativeWindowMirror.probe_update

    def counting(self, keys, *args, **kw):
        calls.append(int(np.asarray(keys).size))
        return real(self, keys, *args, **kw)

    monkeypatch.setattr(NativeWindowMirror, "probe_update", counting)
    s = _Side("port", lane=LANES["on-deferred-sb4"],
              initial_key_capacity=1 << 10)
    _drive(s, BATCHES)
    f = s.op.fused_stats()
    assert f["scan_dispatches"] > 0 and f["scan_steps"] > f["scan_dispatches"]
    # one call per flush with misses: never more calls than flushes
    assert 0 < len(calls) <= f["flushes"]
    assert sum(calls) == s.op.device_probe_stats()["probe_misses"]


# ---------------------------------------------------------------------------
# shard counts on both sides of the C pass's parallel threshold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [MIN_PARALLEL - 1, MIN_PARALLEL,
                                  4 * MIN_PARALLEL])
@pytest.mark.parametrize("shard_div", [0, 3000])
def test_probe_update_shards_bit_identical(rows, shard_div):
    """The C pass at 1 and at 4 shards (slot classes, or slot ranges of
    ``shard_div``): equal slots, scatter ids and mirror bits, below and
    above 2^14 rows, with new keys mid-block and a second pane."""
    rng = np.random.default_rng(rows + shard_div)
    keys = rng.integers(-(1 << 40), 1 << 40, 3000)[
        rng.integers(0, 3000, rows)].astype(np.int64)
    panes = np.sort(rng.integers(4, 6, rows)).astype(np.int64)
    vals = rng.standard_normal(rows).astype(np.float32)
    ivals = rng.integers(-50, 50, rows).astype(np.int32)
    results = []
    for shards in (1, 4):
        ki = NativeKeyIndex()
        ki.lookup_or_insert(keys[:100])           # some keys known before
        spec = pfn.TupleAggregator({"a": ("v", pfn.SumAggregator()),
                                    "b": ("v", pfn.MaxAggregator()),
                                    "c": ("i", pfn.MinAggregator(
                                        np.int32))}).acc_spec()
        nm = NativeWindowMirror.create(ki, spec, ("add", "max", "min"),
                                       (np.float64, np.float64, np.int64))
        flat = np.full(rows + 5, -7, np.int32)
        ns = np.zeros(4, np.int64)
        slots = nm.probe_update(keys, panes, [vals, vals, ivals],
                                pane_mod=16, flat_out=flat, flat_fill=99,
                                shards=shards, shard_div=shard_div,
                                shard_ns=ns)
        ex = [nm.export_pane(p, ki.num_keys) for p in (4, 5)]
        results.append((slots.tobytes(), flat.tobytes(),
                        [(e, c.tobytes(), [l.tobytes() for l in ls])
                         for e, c, ls in ex]))
        assert np.array_equal(flat[:rows], slots * 16 + panes % 16)
        assert (flat[rows:] == 99).all()
        assert (ns[:shards] >= 0).all()
        assert np.array_equal(ki.reverse_keys()[slots], keys)
    assert results[0] == results[1]


@pytest.mark.parametrize("batch", [4000, 2 * MIN_PARALLEL])
def test_operator_shards_bit_identical(batch):
    """The operator at native_shards 1 and 4 on batches below and above
    2^14 rows: bit-identical fires and snapshots, with the probe off (the C
    pass takes every row) and on (it takes the misses)."""
    batches = _batches(n_batches=6, nk=3 * batch // 2, b=batch, seed=5)
    for lane in (LANES["off-scatter-sb1"], LANES["on-deferred-sb4"]):
        runs = []
        for shards in (1, 4):
            s = _Side("port", shards=shards, lane=lane)
            out, snap = _drive(s, batches, 2)
            runs.append((_digests(out), _snap_bytes(snap)))
        assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# the keydict
# ---------------------------------------------------------------------------

def _key_sets():
    rng = np.random.default_rng(3)
    info = np.iinfo(np.int64)
    extreme = np.array([info.min, info.max, 0, -1, 1, info.min + 1,
                        info.max - 1, 1 << 32, -(1 << 32)], np.int64)
    return {
        "random": [rng.integers(info.min, info.max, 5000, dtype=np.int64)
                   for _ in range(3)],
        "negative": [-rng.integers(1, 10_000, 4000).astype(np.int64)
                     for _ in range(3)],
        "extreme": [np.concatenate([extreme, extreme[::-1]]),
                    rng.choice(extreme, 50)],
        "dense-dups": [rng.integers(0, 300, 2000).astype(np.int64)
                       for _ in range(4)],
    }


@pytest.mark.parametrize("kind", list(_key_sets()))
def test_keydict_slots_equal_both_key_indexes(kind):
    """The C keydict's slot ids equal the port's numpy KeyIndex's and the
    JAX KeyIndex's over several calls (first-occurrence numbering), and so
    do lookups (absent keys -1), reverse keys and restores."""
    calls = _key_sets()[kind]
    idx = [NativeKeyIndex(initial_capacity=16), KeyIndex(), JaxKeyIndex()]
    for keys in calls:
        got = [ki.lookup_or_insert(keys) for ki in idx]
        assert got[0].dtype == np.int32
        assert np.array_equal(got[0], got[1])
        assert np.array_equal(got[0], got[2])
        # the incremental reverse copy stays equal after every call
        assert np.array_equal(idx[0].reverse_keys(), idx[1].reverse_keys())
    probe = np.concatenate([calls[0][:50], np.array([12345678901], np.int64)])
    looks = [ki.lookup(probe) for ki in idx]
    assert np.array_equal(looks[0], looks[1])
    assert np.array_equal(looks[0], looks[2])
    snap = idx[0].snapshot()
    assert np.array_equal(snap["reverse"], idx[2].snapshot()["reverse"])
    back = NativeKeyIndex.restore(snap)
    assert back.num_keys == idx[0].num_keys
    assert np.array_equal(back.lookup(snap["reverse"]),
                          np.arange(back.num_keys, dtype=np.int32))


def test_device_key_index_loads_native_key_index():
    """``DeviceKeyIndex.ensure_loaded`` takes the keydict-backed index as it
    is, and probes to the same slots."""
    import torch

    from flink_tpu_torch.state.device_keyindex import (DeviceKeyIndex,
                                                       torch_probe)
    rng = np.random.default_rng(9)
    ki = NativeKeyIndex()
    dki = DeviceKeyIndex(initial_capacity=1 << 10, device="cpu")
    for _ in range(3):
        keys = rng.integers(-(1 << 50), 1 << 50, 700).astype(np.int64)
        ki.lookup_or_insert(keys)
        assert dki.ensure_loaded(ki) > 0
    probe = np.concatenate([keys, np.array([7, -7], np.int64)])
    got = torch_probe(dki.buckets, torch.from_numpy(probe)).numpy()
    assert np.array_equal(got, ki.lookup(probe))


# ---------------------------------------------------------------------------
# snapshots across packages and mirrors, both ways
# ---------------------------------------------------------------------------

def test_snapshot_round_trip_port_native_jax_native_port_numpy():
    """port native -> JAX native -> port numpy, and back: each hop restores
    the previous hop's mid-stream snapshot and replays.  Every hop's
    snapshot equals the first one and every hop's replayed fires equal the
    first hop's, bit for bit; they equal the uninterrupted run's to 1e-6 (a
    restore re-seeds the mirror in device precision, f32, in both
    packages)."""
    lane = LANES["on-deferred-sb4"]
    head, tail = BATCHES[:SNAP_AT + 1], BATCHES[SNAP_AT + 1:]
    first = _Side("port", lane=lane, initial_key_capacity=1 << 10)
    _out, snap = _drive(first, head, SNAP_AT, end=False)
    want, _ = _drive(first, tail)
    hops = [("jax", True), ("port", False), ("jax", True), ("port", True)]
    replayed = None
    for side, native in hops:
        s = _Side(side, native=native, lane=lane,
                  initial_key_capacity=1 << 10)
        s.call("restore_state",
               snapshot_to_jax(snap) if side == "jax" else snap)
        assert s.native_active == native
        again = s.call("snapshot_state")
        again = snapshot_from_jax(again) if side == "jax" else again
        assert _snap_bytes(again) == _snap_bytes(snap), (side, native)
        got, _ = _drive(s, tail)
        _assert_fires_equal(got, want, bits=False)
        replayed = replayed or got
        _assert_fires_equal(got, replayed)
        snap = again


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def test_failed_host_build_raises(monkeypatch, tmp_path):
    """With no compiler, or one that fails, the first batch of a
    ``native_emit=True`` operator raises with the compiler's story; nothing
    falls back to the numpy mirror."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_libs", {})
    batch = RecordBatch({"k": np.arange(4, dtype=np.int64),
                         "v": np.ones(4, np.float32)},
                        timestamps=np.arange(4, dtype=np.int64))
    for cxx, match in (("no-such-compiler-here", "not found"),
                       (shutil.which("false") or "false", "false failed")):
        monkeypatch.setattr(build, "HOST_CXX", cxx)
        s = _Side("port")
        with pytest.raises(RuntimeError, match=match):
            s.op.process_batch(batch)
        assert not s.native_active
    assert not list(tmp_path.glob("*.so"))


def test_native_emit_options(monkeypatch):
    """native_shards=0 is JAX's measured auto (here pinned through
    ``FLINK_TPU_NATIVE_SHARDS``, the cached verdict put back after); a
    negative count is refused; the C lane is the default, as in JAX."""
    from flink_tpu_torch.state import native_mirror as pnm
    monkeypatch.setattr(pnm, "_calibrated_shards", None)
    monkeypatch.setenv("FLINK_TPU_NATIVE_SHARDS", "3")
    s = _Side("port", shards=0)
    s.feed(np.arange(8), np.ones(8), np.zeros(8, np.int64))
    assert s.native_active and s.op._nm_shards == 3
    with pytest.raises(ValueError, match="native_shards"):
        _Side("port", shards=-1)
    op = WindowAggOperator(pwin.TumblingEventTimeWindows.of(100),
                           pfn.SumAggregator(), key_column="k",
                           value_column="v", device="cpu", emit_tier="host")
    assert op.native_emit is True


def test_host_library_loads_beside_the_jax_library():
    """The port's library and the JAX package's ``libflink_native`` live in
    one process: the port's names all carry ``ftt_``, so neither shadows
    the other."""
    from flink_tpu.native import get_lib
    jlib = get_lib()
    if jlib is None:
        pytest.skip("the JAX package's native library did not build here")
    plib = build.host_mirror_lib()
    assert not hasattr(plib, "keydict_create") or \
        plib.keydict_create is not jlib.keydict_create
    jd = jlib.keydict_create(64)
    keys = np.array([5, 9, 5, -3], np.int64)
    out = np.empty(4, np.int32)
    jlib.keydict_lookup_or_insert(jd, keys.ctypes.data, 4, out.ctypes.data)
    jlib.keydict_destroy(jd)
    assert np.array_equal(out, NativeKeyIndex().lookup_or_insert(keys))
    assert int(plib.ftt_hw_threads()) >= 1
    assert ctypes.cast(plib.ftt_keydict_create, ctypes.c_void_p).value != \
        ctypes.cast(jlib.keydict_create, ctypes.c_void_p).value

"""Port parity for object keys: ``flink_tpu_torch.state.keyindex``
``ObjectKeyIndex`` (numpy only; JAX's is built on ``pd.factorize``) and the
operators that key by strings through it, against ``flink_tpu`` on the CPU.

- The index: slot ids equal JAX's for str, bytes, tuple and mixed columns
  batch by batch, ``lookup`` gives -1 for absent keys, a null key (None,
  NaN) raises ``ValueError`` on insert, and ``factorize`` equals pandas'
  ``factorize`` (codes and first-seen uniques).
- The window operator with string keys on the host tier (scatter and
  deferred sync, super-batched, pipelined) and the device tier (plain and
  paged): every fire bit for bit, key columns by value; the object index
  takes the numpy mirror and no device probe, as JAX's does.  Snapshots
  restore across the packages both ways.
- The rescale lane (``state/redistribute.py``), the device join's
  factorization, the heap's ``test_string_keys_use_object_index``, and the
  count-slide and ``minBy`` operators.  The other operators' string-key
  cases live in their own files (basic, session, evicting, changelog
  aggregate, CEP).
"""

import numpy as np
import pandas as pd
import pytest

import jax.numpy as jnp

from flink_tpu.core import functions as jfn
from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.core.batch import Watermark as JaxWatermark
from flink_tpu.operators.count_window import \
    CountSlideWindowOperator as JaxCountSlide
from flink_tpu.operators.window_agg import WindowAggOperator as JaxOp
from flink_tpu.state import keyindex as jki
from flink_tpu.state import redistribute as jredist
from flink_tpu.state.paging import PagingConfig as JaxPaging
from flink_tpu.windowing.assigners import TumblingEventTimeWindows as JaxTumbling
from flink_tpu_torch.core import functions as pfn
from flink_tpu_torch.core.batch import RecordBatch, Watermark
from flink_tpu_torch.interop import snapshot_from_jax, snapshot_to_jax
from flink_tpu_torch.operators.count_window import CountSlideWindowOperator
from flink_tpu_torch.operators.window_agg import WindowAggOperator
from flink_tpu_torch.ops import join_kernels as pjk
from flink_tpu_torch.state import keyindex as pki
from flink_tpu_torch.state import redistribute as predist
from flink_tpu_torch.state.paging import PagingConfig
from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows
from test_torch_calibration import verdicts  # noqa: F401 — the fixture


def _column(items):
    items = list(items)
    col = np.empty(len(items), object)
    col[:] = items
    return col


def _columns(kind, seed=0, n=600):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(40)] + ["", "é", "日本", "a b"]
    if kind == "str":
        return _column(words[i] for i in rng.integers(0, len(words), n))
    if kind == "str_fixed":           # a U array, as numpy builds from text
        return np.asarray([words[i] for i in
                           rng.integers(0, len(words), n)])
    if kind == "bytes":
        return _column(words[i].encode() for i in
                       rng.integers(0, len(words), n))
    if kind == "tuple":
        return _column((int(a), words[b]) for a, b in
                       zip(rng.integers(0, 4, n), rng.integers(0, 5, n)))
    pool = [1, 2.5, "x", b"x", (1, "a"), True, 7, "y", 2]
    return _column(pool[i] for i in rng.integers(0, len(pool), n))


KINDS = ["str", "str_fixed", "bytes", "tuple", "mixed"]


def _norm(keys):
    """Reverse keys comparable across packages: JAX's object array of tuple
    keys is 2-D (``np.asarray(list, object)``)."""
    return [tuple(k) if isinstance(k, np.ndarray) else k for k in keys]


@pytest.mark.parametrize("kind", KINDS)
def test_object_index_slots_equal_jax(kind):
    col = _columns(kind)
    j, p = jki.ObjectKeyIndex(), pki.ObjectKeyIndex()
    for lo in range(0, col.size, 150):
        part = col[lo:lo + 150]
        want, got = j.lookup_or_insert(part), p.lookup_or_insert(part)
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)
    assert p.num_keys == j.num_keys
    assert _norm(p.reverse_keys()) == _norm(j.reverse_keys())
    probe = np.concatenate([col[:20], _column(["absent", b"no", (9, "z")])])
    assert np.array_equal(p.lookup(probe), j.lookup(probe))
    assert (p.lookup(_column(["absent"])) == -1).all()
    back = pki.ObjectKeyIndex.restore(p.snapshot())
    assert np.array_equal(back.lookup(col), j.lookup(col))


@pytest.mark.parametrize("kind", KINDS)
def test_factorize_equals_pandas(kind):
    col = _columns(kind, seed=3, n=300)
    codes, uniques = pki.factorize(col)
    pcodes, puniques = pd.factorize(np.asarray(col, dtype=object))
    assert np.array_equal(codes, pcodes)
    assert list(uniques) == list(puniques)


@pytest.mark.parametrize("bad", [None, float("nan"), np.float64("nan")])
def test_null_keys_raise_and_miss(bad):
    col = _column(["a", bad, "b"])
    for ki in (pki.ObjectKeyIndex(), jki.ObjectKeyIndex()):
        with pytest.raises(ValueError, match="null"):
            ki.lookup_or_insert(col)
        assert ki.num_keys == 0
    p, j = pki.ObjectKeyIndex(), jki.ObjectKeyIndex()
    p.lookup_or_insert(_column(["a"]))
    j.lookup_or_insert(_column(["a"]))
    assert np.array_equal(p.lookup(col), j.lookup(col))


def test_make_key_index_routes_as_jax():
    for sample in (np.int64(3), 7, np.uint8(1)):
        assert isinstance(pki.make_key_index(sample), pki.NativeKeyIndex)
        assert isinstance(jki.make_key_index(sample), jki.KeyIndex)
    for sample in ("a", b"a", (1, 2), np.asarray([1, 2]), 1.5):
        assert isinstance(pki.make_key_index(sample), pki.ObjectKeyIndex)
        assert isinstance(jki.make_key_index(sample), jki.ObjectKeyIndex)
    snap = {"reverse": _column(["a", "b"])}
    back = pki.restore_key_index(snap, "ObjectKeyIndex")
    assert isinstance(back, pki.ObjectKeyIndex)
    assert list(back.lookup(_column(["b", "a", "c"]))) == [1, 0, -1]


# ---------------------------------------------------------------------------
# the window operator
# ---------------------------------------------------------------------------

def _word_batches(n_batches=9, n=1500, vocab=400, seed=11):
    rng = np.random.default_rng(seed)
    words = np.asarray([f"w{i:04d}" for i in range(vocab)], object)
    out = []
    for i in range(n_batches):
        keys = words[rng.zipf(1.3, n) % vocab]
        vals = rng.random(n).astype(np.float32)
        if i == 7:   # out of order: straddles a fired window, half late
            ts = 250 + np.sort(rng.integers(0, 100, n))
        else:
            ts = i * 50 + np.sort(rng.integers(0, 50, n))
        out.append((keys, vals, ts.astype(np.int64)))
    return out


BATCHES = _word_batches()


def _bits(a):
    a = np.asarray(a)
    if a.dtype == object:
        return a.dtype.str, a.shape, tuple(a.tolist())
    return a.dtype.str, a.shape, a.tobytes()


def _view(out):
    return [tuple((c, _bits(b.column(c))) for c in sorted(b.columns))
            + (_bits(b.timestamps),) for b in out]


def _drive(op, batches, RB, WM, snap_at=None):
    before, after, snap = [], [], None
    for i, (keys, vals, ts) in enumerate(batches):
        out = op.process_batch(RB({"k": keys, "v": vals}, timestamps=ts))
        out += op.process_watermark(WM(int(ts.max()) - 1))
        (after if snap is not None else before).extend(out)
        if i == snap_at:
            op.prepare_snapshot_pre_barrier()
            snap = op.snapshot_state()
    (after if snap is not None else before).extend(op.end_input())
    return before, after, snap


LANES = {
    "host-scatter": dict(emit_tier="host", snapshot_source="mirror",
                         device_sync="scatter"),
    "host-deferred": dict(emit_tier="host", snapshot_source="mirror",
                          device_sync="deferred"),
    "host-superbatch": dict(emit_tier="host", snapshot_source="mirror",
                            device_sync="deferred", superbatch=4),
    "host-pipelined": dict(emit_tier="host", snapshot_source="mirror",
                           device_sync="scatter", pipeline_depth=2),
    "device": dict(emit_tier="device", snapshot_source="device",
                   device_sync="scatter"),
    "device-paged": dict(emit_tier="device", snapshot_source="device",
                         device_sync="scatter", paging="paging"),
}


def _op(side, lane):
    kw = dict(LANES[lane])
    kw.setdefault("superbatch", 1)
    kw.setdefault("pipeline_depth", 0)
    if kw.get("paging") == "paging":
        kw["paging"] = (JaxPaging if side == "jax" else PagingConfig)(
            capacity=128)
    if side == "jax":
        op = JaxOp(JaxTumbling.of(100), jfn.SumAggregator(jnp.float32),
                   key_column="k", value_column="v", device_probe="on", **kw)
        op.open(jfn.RuntimeContext())
    else:
        op = WindowAggOperator(TumblingEventTimeWindows.of(100),
                               pfn.SumAggregator(), key_column="k",
                               value_column="v", device_probe="on",
                               device="cpu", **kw)
        op.open(pfn.RuntimeContext())
    return op


@pytest.mark.parametrize("lane", list(LANES))
def test_window_operator_string_keys_bit_for_bit(verdicts, lane):  # noqa: F811
    """Every fire and the snapshot equal JAX's; the port binds the object
    index with the numpy mirror and no device probe, as JAX does."""
    verdicts(taxed=False, shards=1, super_shards=1, depth=1, probe=False)
    jop, pop = _op("jax", lane), _op("port", lane)
    jb, ja, jsnap = _drive(jop, BATCHES, JaxBatch, JaxWatermark, snap_at=4)
    pb, pa, psnap = _drive(pop, BATCHES, RecordBatch, Watermark, snap_at=4)
    assert _view(pb) == _view(jb) and _view(pa) == _view(ja)
    assert pb and pa
    assert isinstance(pop.key_index, pki.ObjectKeyIndex)
    assert not pop.native_mirror_active
    assert pop.device_probe_stats()["enabled"] == 0
    assert pop.late_dropped == jop.late_dropped > 0
    assert psnap["key_index_kind"] == jsnap["key_index_kind"] \
        == "ObjectKeyIndex"
    assert list(psnap["key_index"]["reverse"]) \
        == list(jsnap["key_index"]["reverse"])
    for f in ("counts",):
        assert _bits(psnap[f]) == _bits(jsnap[f])
    for a, b in zip(psnap["leaves"], jsnap["leaves"], strict=True):
        assert _bits(a) == _bits(b)


@pytest.mark.parametrize("lane", ["host-scatter", "device"])
def test_window_snapshots_restore_across_packages(verdicts, lane):  # noqa: F811
    """A string-keyed snapshot of either package restores into the other,
    and the rest of the stream fires as the writer's own restore does (the
    host tier re-seeds its f64 mirror from the f32 cells on a restore, in
    both packages, so a restore is held to a restore)."""
    verdicts(taxed=False, shards=1, super_shards=1, depth=1, probe=False)
    _, _, jsnap = _drive(_op("jax", lane), BATCHES, JaxBatch, JaxWatermark,
                         snap_at=4)
    _, _, psnap = _drive(_op("port", lane), BATCHES, RecordBatch, Watermark,
                         snap_at=4)
    rest = BATCHES[5:]

    def resumed(side, snap):
        op = _op(side, lane)
        op.restore_state(snap)
        if side == "jax":
            return _view(_drive(op, rest, JaxBatch, JaxWatermark)[0])
        assert isinstance(op.key_index, pki.ObjectKeyIndex)
        return _view(_drive(op, rest, RecordBatch, Watermark)[0])
    want = resumed("jax", jsnap)
    assert want and resumed("port", snapshot_from_jax(jsnap)) == want
    assert resumed("jax", snapshot_to_jax(psnap)) == want
    assert resumed("port", psnap) == want


# ---------------------------------------------------------------------------
# redistribution, the device join, the heap, count-slide, minBy
# ---------------------------------------------------------------------------

def test_rescale_split_and_merge_object_keys():
    """A string-keyed snapshot splits by key group and merges back exactly
    as JAX's does: the same rows in each part, re-indexed alike."""
    keys = _column(f"k{i}" for i in range(200))
    idx = pki.ObjectKeyIndex()
    idx.lookup_or_insert(keys)
    snap = {"key_index": idx.snapshot(), "key_index_kind": "ObjectKeyIndex",
            "rows": np.arange(200, dtype=np.float64)}
    jsnap = dict(snap, key_index={"reverse": jki.ObjectKeyIndex.restore(
        idx.snapshot()).reverse_keys()})
    pparts = predist.split_keyed_snapshot(snap, ["rows"], 128, 3)
    jparts = jredist.split_keyed_snapshot(jsnap, ["rows"], 128, 3)
    for p, j in zip(pparts, jparts, strict=True):
        assert list(p["key_index"]["reverse"]) \
            == list(j["key_index"]["reverse"])
        assert np.array_equal(p["rows"], j["rows"])
    merged = predist.merge_keyed_snapshots(pparts, ["rows"])
    jmerged = jredist.merge_keyed_snapshots(jparts, ["rows"])
    assert list(merged["key_index"]["reverse"]) \
        == list(jmerged["key_index"]["reverse"])
    assert np.array_equal(merged["rows"], jmerged["rows"])
    assert merged["key_index_kind"] == "ObjectKeyIndex"


def test_device_join_factorizes_object_keys():
    """The device lane numbers the left keys first-seen and gives absent
    right keys distinct negative codes; its pairs equal JAX's."""
    from flink_tpu.ops import join_kernels as jjk
    rng = np.random.default_rng(4)
    words = _column(f"j{i}" for i in range(30))
    lk, rk = words[rng.integers(0, 30, 200)], words[rng.integers(5, 30, 150)]
    lc, rc = pjk.join_codes(lk, rk)
    assert lc.dtype == rc.dtype == np.int64
    assert (rc[np.isin(rk, lk, invert=True)] < 0).all()
    for g, w in zip(pjk.device_join_pairs(lk, rk, device="cpu"),
                    jjk.device_join_pairs(lk, rk)):
        assert np.array_equal(g, w)


def test_string_keys_use_object_index():
    """``tests/test_state.py::test_string_keys_use_object_index`` on the
    port's heap backend."""
    from flink_tpu_torch.state.api import ValueStateDescriptor
    from flink_tpu_torch.state.heap import HeapKeyedStateBackend
    b = HeapKeyedStateBackend()
    st = b.get_state(ValueStateDescriptor("v", dtype=np.float64, default=0.0))
    slots = b.key_slots(np.array(["a", "b", "a"], dtype=object))
    st.put_rows(slots, np.array([1.0, 2.0, 3.0]))
    b.set_current_key("a")
    assert st.value() == 3.0
    np.testing.assert_array_equal(
        np.sort(b.slot_keys(b.key_slots(np.array(["a", "b"], dtype=object)))),
        ["a", "b"])


def test_count_slide_and_min_by_string_keys():
    from flink_tpu.operators.basic import ExtremumByOperator as JaxExt
    from flink_tpu_torch.operators.basic import ExtremumByOperator

    rng = np.random.default_rng(9)
    keys = _column(f"c{i}" for i in rng.integers(0, 12, 400))
    vals = rng.standard_normal(400)
    tags = _column(f"t{i}" for i in range(400))
    outs = {}
    for side, (CS, Ext, RB, fn) in {
            "jax": (JaxCountSlide, JaxExt, JaxBatch, jfn),
            "port": (CountSlideWindowOperator, ExtremumByOperator,
                     RecordBatch, pfn)}.items():
        cs = CS(fn.SumAggregator(np.float64), key_column="k",
                value_column="v", size=4, slide=2)
        ext = Ext("k", "v", is_min=True)
        rows = []
        for lo in range(0, 400, 100):
            b = RB({"k": keys[lo:lo + 100], "v": vals[lo:lo + 100],
                    "tag": tags[lo:lo + 100]},
                   timestamps=np.arange(lo, lo + 100, dtype=np.int64))
            rows += [r for o in cs.process_batch(b) + ext.process_batch(b)
                     for r in o.to_rows()]
        outs[side] = (rows, cs.snapshot_state()["key_index_kind"])
    assert outs["port"] == outs["jax"]
    assert outs["port"][1] == "ObjectKeyIndex" and outs["port"][0]

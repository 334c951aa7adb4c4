"""Port parity for the device equi-join and the join operators:
``flink_tpu_torch.ops.join_kernels``, ``flink_tpu_torch.operators.joins``
and the joins of ``flink_tpu_torch.operators.sql_ops`` against
``flink_tpu``'s on the CPU, on numpy-seeded inputs.

The pair functions are held to JAX's exactly and in order: the port's plain
version (what CPU tensors run) and its torch ops (what the card runs, here
on CPU tensors) against ``_pair_count``/``_pair_emit`` on JAX's dense codes
and against ``device_join_pairs``.  Every operator runs under both lanes of
``_join_pairs`` (``FLINK_TPU_DEVICE_JOIN`` unset: host numpy; ``=1``: the
device join, on ``device="cpu"`` in the port) and its output is compared
with JAX's under the same lane: columns, dtypes, timestamps and row order.
Snapshots restore across the packages both ways.  None of these JAX paths
imports ``jax.experimental.enable_x64``, so no shim is needed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.core.batch import Watermark as JaxWatermark
from flink_tpu.operators import joins as jjoins
from flink_tpu.operators import sql_ops as jsql
from flink_tpu.ops import join_kernels as jk
from flink_tpu.state.keyindex import KeyIndex as JaxKeyIndex
from flink_tpu.windowing.assigners import \
    TumblingEventTimeWindows as JaxTumbling
from flink_tpu_torch.core.batch import RecordBatch, Watermark
from flink_tpu_torch.operators import joins as pjoins
from flink_tpu_torch.operators import sql_ops as psql
from flink_tpu_torch.ops import join_kernels as pk
from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

LANES = ["host", "device"]

SIDES = {
    "jax": dict(joins=jjoins, sql=jsql, RB=JaxBatch, WM=JaxWatermark,
                Tumbling=JaxTumbling, kw={}),
    "port": dict(joins=pjoins, sql=psql, RB=RecordBatch, WM=Watermark,
                 Tumbling=TumblingEventTimeWindows, kw={"device": "cpu"}),
}


@pytest.fixture(params=LANES)
def lane(request, monkeypatch):
    if request.param == "device":
        monkeypatch.setenv("FLINK_TPU_DEVICE_JOIN", "1")
    else:
        monkeypatch.delenv("FLINK_TPU_DEVICE_JOIN", raising=False)
    return request.param


def _column(a):
    a = np.asarray(a)
    if a.dtype.kind == "O":
        return "O", tuple((type(x).__name__, x) for x in a.tolist())
    return a.dtype.str, a.shape, a.tobytes()


def _views(out):
    """Every element: each column's dtype and bits (object columns by
    value and type), the timestamps; watermarks by time."""
    views = []
    for e in out:
        if hasattr(e, "columns"):
            views.append((tuple((c, _column(e.column(c))) for c in e.columns),
                          None if e.timestamps is None
                          else _column(e.timestamps)))
        else:
            views.append(("wm", e.timestamp))
    return views


# ---------------------------------------------------------------------------
# the pair functions
# ---------------------------------------------------------------------------

def _keys(case, rng):
    if case == "duplicates":
        return (rng.integers(0, 40, 300).astype(np.int64),
                rng.integers(0, 40, 250).astype(np.int64))
    if case == "absent":        # right keys absent from the left, and back
        return (rng.integers(0, 100, 400).astype(np.int64),
                rng.integers(50, 200, 400).astype(np.int64))
    if case == "wide":          # int64 keys past 2^31
        base = np.array([2 ** 31, 2 ** 40 + 7, -2 ** 62, 2 ** 63 - 1,
                         -2 ** 63, 3 * 2 ** 33], np.int64)
        return (rng.choice(base, 200), rng.choice(base[1:], 150))
    if case == "skewed":        # one key on a third of each side's rows
        lk = rng.integers(0, 1000, 600).astype(np.int64)
        rk = rng.integers(0, 1000, 600).astype(np.int64)
        lk[rng.random(600) < 1 / 3] = 17
        rk[rng.random(600) < 1 / 3] = 17
        return lk, rk
    if case == "no_match":
        return np.arange(10, dtype=np.int64), np.arange(10, 20,
                                                        dtype=np.int64)
    return np.array([5], np.int64), np.array([5], np.int64)


def _jax_codes(lk, rk):
    """JAX's ``device_join_pairs`` factorization: dense left codes, distinct
    negative codes for right keys absent from the left."""
    ki = JaxKeyIndex()
    lc = ki.lookup_or_insert(lk).astype(np.int64)
    rc = ki.lookup(rk).astype(np.int64)
    return lc, np.where(rc < 0, -(np.arange(rc.size) + 2), rc)


CASES = ["duplicates", "absent", "wide", "skewed", "no_match", "single"]


@pytest.mark.parametrize("case", CASES)
def test_device_join_pairs_equals_jax(case):
    rng = np.random.default_rng(CASES.index(case))
    lk, rk = _keys(case, rng)
    want = jk.device_join_pairs(lk, rk)
    got = pk.device_join_pairs(lk, rk, device="cpu")
    for w, g in zip(want, got):
        assert g.dtype == w.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    # ... and the host lane's pairs, as a multiset
    hl, hr = jjoins._join_pairs(lk, rk)
    assert sorted(zip(hl.tolist(), hr.tolist())) == \
        sorted(zip(got[0].tolist(), got[1].tolist()))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("route", ["plain", "torch_ops"])
def test_pair_count_and_emit_equal_jax(case, route):
    """Function by function against JAX's jitted steps on its codes: the
    count, and the emit at JAX's quantized capacity and at a capacity that
    truncates, pairs and -1 padding exactly."""
    rng = np.random.default_rng(10 + CASES.index(case))
    lk, rk = _keys(case, rng)
    lc, rc = _jax_codes(lk, rk)
    n = int(jk._pair_count(jnp.asarray(lc), jnp.asarray(rc)))
    tl, tr = torch.from_numpy(lk), torch.from_numpy(rk)
    if route == "plain":
        assert int(pk.pair_count(tl, tr)) == n
    else:
        assert int(pk.spans(tl, tr)[2].sum()) == n
    for cap in {jk._quantize(max(n, 1)), max(n // 2, 1)}:
        jl, jr, jn = jk._pair_emit(jnp.asarray(lc), jnp.asarray(rc), cap)
        if route == "plain":
            li, ri, pn = pk.pair_emit(tl, tr, cap)
        else:
            ro, lo, counts = pk.spans(tl, tr)
            pn = counts.sum()
            li, ri = pk.expand(ro, lo, counts, pn, cap)
        assert int(pn) == int(jn) == n
        assert li.dtype == ri.dtype == torch.int32
        np.testing.assert_array_equal(li.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(ri.numpy(), np.asarray(jr))


def test_device_join_pairs_empties():
    for lk, rk in ((np.zeros(0, np.int64), np.arange(3)),
                   (np.arange(3), np.zeros(0, np.int64)),
                   (np.zeros(0, np.int64), np.zeros(0, np.int64))):
        for li, ri in (pk.device_join_pairs(lk, rk, device="cpu"),
                       jk.device_join_pairs(lk, rk)):
            assert li.dtype == ri.dtype == np.int64
            assert li.size == ri.size == 0


def test_device_lane_refuses_object_keys():
    """Keys that are not integers (strings, floats, mixed objects) are
    factorized to dense codes on the device lane, as JAX's are (the name is
    from when the port refused them), and give JAX's pairs; an object
    column of integers (rows built from tuples) joins like its int64
    array."""
    rng = np.random.default_rng(12)
    words = np.array(["ab", "cd", "ef", "gh", "ij", "kl"], object)
    for lk, rk in ((rng.choice(words, 60), rng.choice(words[2:], 45)),
                   (np.array([1.5, 2.0, 1.5]), np.array([1.5, 3.0])),
                   (np.array([1, "a", 1], object), np.array([1, "b"],
                                                            object))):
        got = pk.device_join_pairs(lk, rk, device="cpu")
        want = jk.device_join_pairs(lk, rk)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int64
            np.testing.assert_array_equal(g, w)
    lk = np.array([3, 1, 3, 2], np.int64)
    rk = np.array([np.int64(3), 2, 3], object)
    got = pk.device_join_pairs(lk.astype(object), rk, device="cpu")
    want = jk.device_join_pairs(lk.astype(object), rk)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_host_lane_object_keys_equal_jax(monkeypatch):
    monkeypatch.delenv("FLINK_TPU_DEVICE_JOIN", raising=False)
    rng = np.random.default_rng(3)
    words = np.array(["ab", "cd", "ef", "gh", "ij"], object)
    lk, rk = rng.choice(words, 50), rng.choice(words[1:], 40)
    for g, w in zip(pjoins._join_pairs(lk, rk), jjoins._join_pairs(lk, rk)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_device_lane_defaults_to_the_card(monkeypatch):
    """The device lane resolves the operator's device when it runs: the
    card by default, which raises without one.  The host lane needs no
    device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    op = pjoins.IntervalJoinOperator("k", "k", -5, 5)
    left = RecordBatch({"k": np.array([1, 2])}, timestamps=np.array([0, 1]))
    right = RecordBatch({"k": np.array([1])}, timestamps=np.array([2]))
    op.process_batch2(left, 0)
    op.process_batch2(right, 1)
    monkeypatch.delenv("FLINK_TPU_DEVICE_JOIN", raising=False)
    snap = op.snapshot_state()
    assert len(op.process_watermark(Watermark(100))) == 1
    op.restore_state(snap)
    monkeypatch.setenv("FLINK_TPU_DEVICE_JOIN", "1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        op.process_watermark(Watermark(100))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pk.device_join_pairs(np.array([1]), np.array([1]))


# ---------------------------------------------------------------------------
# interval and window joins
# ---------------------------------------------------------------------------

def _stream(seed, n_batches=6, size=200, n_keys=60):
    rng = np.random.default_rng(seed)
    out, t = [], 0
    for _ in range(n_batches):
        k = rng.integers(0, n_keys, size).astype(np.int64)
        v = rng.random(size).astype(np.float32)
        ts = t + np.sort(rng.integers(0, 100, size)).astype(np.int64)
        t += 100
        out.append((k, v, ts))
    return out


def _drive_two_input(op, side, left, right, start=0, stop=None, end=True):
    """Left batch, right batch, then a watermark at the pair's largest
    timestamp; ``end_input`` last.  Returns the outputs."""
    stop = len(left) if stop is None else stop
    out = []
    for i in range(start, stop):
        for idx, (k, v, ts) in ((0, left[i]), (1, right[i])):
            cols = {"k": k, "v": v, "e": np.arange(k.size) + 1000 * i}
            out += op.process_batch2(side["RB"](cols, timestamps=ts), idx)
        wm = int(max(left[i][2].max(), right[i][2].max()))
        out += op.process_watermark(side["WM"](wm))
    if end:
        out += op.end_input()
    return out


def _interval(side):
    return side["joins"].IntervalJoinOperator("k", "k", -50, 50,
                                              **side["kw"])


def test_interval_join_equals_jax(lane):
    left, right = _stream(1), _stream(2)
    outs, snaps = {}, {}
    for name, side in SIDES.items():
        op = _interval(side)
        first = _drive_two_input(op, side, left, right, stop=3, end=False)
        snaps[name] = op.snapshot_state()
        outs[name] = first + _drive_two_input(op, side, left, right,
                                              start=3)
    assert _views(outs["port"]) == _views(outs["jax"])
    assert sum(len(b) for b in outs["port"]) > 100
    # snapshots restore across the packages both ways
    for src, dst in (("jax", "port"), ("port", "jax")):
        op = _interval(SIDES[dst])
        op.restore_state(snaps[src])
        rest = _drive_two_input(op, SIDES[dst], left, right, start=3)
        assert _views(rest) == _views(outs[dst][len(outs[dst]) - len(rest):])


def test_interval_join_lanes_give_the_same_pairs(monkeypatch):
    """The device lane orders pairs left-major, the host lane by key: the
    same (left row, right row) multiset."""
    left, right = _stream(4), _stream(5)
    pairs = {}
    for lane_ in LANES:
        if lane_ == "device":
            monkeypatch.setenv("FLINK_TPU_DEVICE_JOIN", "1")
        else:
            monkeypatch.delenv("FLINK_TPU_DEVICE_JOIN", raising=False)
        out = _drive_two_input(_interval(SIDES["port"]), SIDES["port"],
                               left, right)
        pairs[lane_] = sorted(
            (int(a), int(b)) for o in out
            for a, b in zip(o.column("e"), o.column("r_e")))
    assert pairs["host"] == pairs["device"] and pairs["host"]


def test_interval_join_output_fn_and_cleanup(lane):
    left, right = _stream(6, n_batches=4), _stream(7, n_batches=4)
    outs = {}
    for name, side in SIDES.items():
        op = side["joins"].IntervalJoinOperator(
            "k", "k", 0, 30, output_fn=lambda c: {"k": c["k"],
                                                   "d": c["v"] - c["r_v"]},
            **side["kw"])
        outs[name] = _drive_two_input(op, side, left, right)
        outs[name + " buffered"] = (len(op.left.batches),
                                    len(op.right.batches))
    assert _views(outs["port"]) == _views(outs["jax"])
    assert outs["port buffered"] == outs["jax buffered"]


@pytest.mark.parametrize("cogroup", [False, True])
def test_window_join_equals_jax(lane, cogroup):
    left, right = _stream(8), _stream(9)

    def apply_fn(key, bounds, lrows, rrows):
        return {"k": key, "n": len(lrows) * 100 + len(rrows)}

    outs, snaps = {}, {}
    for name, side in SIDES.items():
        op = side["joins"].WindowJoinOperator(
            side["Tumbling"].of(150), "k", "k",
            apply_fn=apply_fn if cogroup else None, cogroup=cogroup,
            **side["kw"])
        first = _drive_two_input(op, side, left, right, stop=3, end=False)
        snaps[name] = op.snapshot_state()
        outs[name] = first + _drive_two_input(op, side, left, right, start=3)
    assert _views(outs["port"]) == _views(outs["jax"])
    assert sum(len(b) for b in outs["port"]) > 50
    for src, dst in (("jax", "port"), ("port", "jax")):
        side = SIDES[dst]
        op = side["joins"].WindowJoinOperator(
            side["Tumbling"].of(150), "k", "k",
            apply_fn=apply_fn if cogroup else None, cogroup=cogroup,
            **side["kw"])
        op.restore_state(snaps[src])
        rest = _drive_two_input(op, side, left, right, start=3)
        assert _views(rest) == _views(outs[dst][len(outs[dst]) - len(rest):])


def test_window_join_refuses_sliding_windows():
    from flink_tpu_torch.windowing.assigners import SlidingEventTimeWindows
    with pytest.raises(ValueError, match="tumbling"):
        pjoins.WindowJoinOperator(SlidingEventTimeWindows.of(100, 50),
                                  "k", "k", device="cpu")


# ---------------------------------------------------------------------------
# the SQL joins
# ---------------------------------------------------------------------------

def _table(rng, n, n_keys, key, val, obj=False):
    k = rng.integers(0, n_keys, n).astype(np.int64)
    v = rng.integers(0, 1000, n).astype(np.int64)
    if obj:
        k = np.array([f"k{x}" for x in k], object)
    return {key: k, val: v}


@pytest.mark.parametrize("how", ["inner", "left", "right", "full"])
def test_sql_join_equals_jax(lane, how):
    rng = np.random.default_rng(["inner", "left", "right", "full"].index(how))
    lparts = [_table(rng, 70, 40, "k", "x") for _ in range(3)]
    rparts = [_table(rng, 50, 60, "k2", "y") for _ in range(2)]
    outs, snaps = {}, {}
    for name, side in SIDES.items():
        op = side["sql"].SqlJoinOperator(
            "k", "k2", how, {"y": "ry"}, left_columns=["k", "x"],
            right_columns=["k2", "y"], **side["kw"])
        op.process_batch2(side["RB"](lparts[0]), 0)
        op.process_batch2(side["RB"](rparts[0]), 1)
        snaps[name] = op.snapshot_state()
        for cols in lparts[1:]:
            op.process_batch2(side["RB"](cols), 0)
        op.process_batch2(side["RB"](rparts[1]), 1)
        outs[name] = op.end_input()
    assert _views(outs["port"]) == _views(outs["jax"])
    for src, dst in (("jax", "port"), ("port", "jax")):
        side = SIDES[dst]
        op = side["sql"].SqlJoinOperator(
            "k", "k2", how, {"y": "ry"}, left_columns=["k", "x"],
            right_columns=["k2", "y"], **side["kw"])
        op.restore_state(snaps[src])
        for cols in lparts[1:]:
            op.process_batch2(side["RB"](cols), 0)
        op.process_batch2(side["RB"](rparts[1]), 1)
        assert _views(op.end_input()) == _views(outs[dst])


@pytest.mark.parametrize("how", ["inner", "full"])
def test_sql_join_object_keys_on_the_host_lane(how, monkeypatch):
    monkeypatch.delenv("FLINK_TPU_DEVICE_JOIN", raising=False)
    rng = np.random.default_rng(5)
    lcols = _table(rng, 40, 20, "k", "x", obj=True)
    rcols = _table(rng, 30, 25, "k2", "y", obj=True)
    outs = {}
    for name, side in SIDES.items():
        op = side["sql"].SqlJoinOperator("k", "k2", how, **side["kw"])
        op.process_batch2(side["RB"](lcols), 0)
        op.process_batch2(side["RB"](rcols), 1)
        outs[name] = op.end_input()
    assert _views(outs["port"]) == _views(outs["jax"])
    # the device lane factorizes the string keys (the object-key slice),
    # as JAX's device lane does
    monkeypatch.setenv("FLINK_TPU_DEVICE_JOIN", "1")
    for name, side in SIDES.items():
        op = side["sql"].SqlJoinOperator("k", "k2", how, **side["kw"])
        op.process_batch2(side["RB"](lcols), 0)
        op.process_batch2(side["RB"](rcols), 1)
        outs[name] = op.end_input()
    assert _views(outs["port"]) == _views(outs["jax"])


def test_sql_join_outer_over_an_empty_side(lane):
    outs = {}
    for name, side in SIDES.items():
        op = side["sql"].SqlJoinOperator(
            "k", "k2", "full", left_columns=["k", "x"],
            right_columns=["k2", "y"], **side["kw"])
        op.process_batch2(side["RB"]({"k": np.array([1, 2]),
                                      "x": np.array([3, 4])}), 0)
        outs[name] = op.end_input()
    assert _views(outs["port"]) == _views(outs["jax"])


# ---------------------------------------------------------------------------
# the streaming join
# ---------------------------------------------------------------------------

LCOLS = ["k", "x"]
RCOLS = ["k2", "y"]


def _sbatch(side, cols_names, rows, ops=None):
    cols = {c: np.asarray([r[j] for r in rows], object)
            for j, c in enumerate(cols_names)}
    if ops is not None:
        cols["op"] = np.asarray(ops, object)
    return side["RB"](cols)


def _streaming(side, how, **kw):
    return side["sql"].StreamingJoinOperator(
        "k", "k2", how, {"y": "ry"}, left_columns=LCOLS,
        right_columns=RCOLS, **kw, **side["kw"])


def _append_feed(seed, n=8, size=30, n_keys=12):
    rng = np.random.default_rng(seed)
    return [(i % 2, [(int(k), int(x)) for k, x in
                     zip(rng.integers(0, n_keys, size),
                         rng.integers(0, 100, size))])
            for i in range(n)]


def _run_feed(op, side, feed, start=0):
    out = []
    for idx, rows, *ops in feed[start:]:
        names = LCOLS if idx == 0 else RCOLS
        out += op.process_batch2(
            _sbatch(side, names, rows, ops[0] if ops else None), idx)
    return out


@pytest.mark.parametrize("how", ["inner", "left", "right", "full"])
def test_streaming_join_append_only_equals_jax(lane, how):
    """Append-only input: the inner join takes the vectorized fast path
    (``_join_pairs`` on the batch against the stored other side), the outer
    joins the per-row path; integer keys held in object columns."""
    feed = _append_feed(["inner", "left", "right", "full"].index(how))
    outs, snaps = {}, {}
    for name, side in SIDES.items():
        op = _streaming(side, how)
        first = _run_feed(op, side, feed[:4])
        snaps[name] = op.snapshot_state()
        outs[name] = first + _run_feed(op, side, feed, start=4)
    assert _views(outs["port"]) == _views(outs["jax"])
    assert sum(len(b) for b in outs["port"]) > 20
    for src, dst in (("jax", "port"), ("port", "jax")):
        op = _streaming(SIDES[dst], how)
        op.restore_state(snaps[src])
        rest = _run_feed(op, SIDES[dst], feed, start=4)
        assert _views(rest) == _views(outs[dst][len(outs[dst]) - len(rest):])


@pytest.mark.parametrize("how", ["inner", "left", "right", "full"])
def test_streaming_join_with_retractions_equals_jax(lane, how):
    feed = [
        (0, [(1, 1), (1, 2)], ["+I", "+I"]),
        (1, [(1, 10), (2, 20)], ["+I", "+I"]),
        (0, [(1, 1)], ["-D"]),
        (1, [(1, 10)], ["-D"]),
        (0, [(2, 3), (1, 2)], ["+I", "-D"]),
        (1, [(2, 20)], ["-U"]),
        (1, [(3, 40)], ["+U"]),
        (0, [(9, 9)], ["-D"]),                 # never accumulated: stale
    ]
    outs = {}
    for name, side in SIDES.items():
        op = _streaming(side, how)
        outs[name] = _run_feed(op, side, feed)
        outs[name + " stale"] = op.stale_retractions
        outs[name + " snap"] = _views([side["RB"](op.snapshot_state()[
            "left"]["cols"])])
    for k in ("", " stale", " snap"):
        assert (outs["port" + k] if k else _views(outs["port"])) == \
            (outs["jax" + k] if k else _views(outs["jax"]))
    assert outs["port stale"] == 1


def test_streaming_join_outer_padding_transitions(lane):
    feed = [(0, [(1, 1)]), (1, [(1, 10)]), (1, [(1, 10)], ["-D"]),
            (0, [(1, 1)], ["-U"])]
    outs = {}
    for name, side in SIDES.items():
        outs[name] = _run_feed(_streaming(side, "full"), side, feed)
    assert _views(outs["port"]) == _views(outs["jax"])
    ops = [o for b in outs["port"] for o in b.column("op").tolist()]
    assert ops == ["+I", "-U", "+U", "-U", "+U", "-D"]


def test_streaming_join_state_ttl_equals_jax(lane, monkeypatch):
    """Processing-time TTL through a patched ``_now_ms`` on both operators:
    expiry sweeps and access-time filtering at the same clock readings."""
    clock = {"now": 1_000_000}
    feed = _append_feed(11, n=10, size=10, n_keys=5)
    outs = {}
    for name, side in SIDES.items():
        clock["now"] = 1_000_000
        op = _streaming(side, "inner", state_ttl_ms=10_000)
        monkeypatch.setattr(op, "_now_ms", lambda: clock["now"])
        out = []
        for i, (idx, rows) in enumerate(feed):
            clock["now"] += 4_000 if i % 3 else 1_000
            out += op.process_batch2(
                _sbatch(side, LCOLS if idx == 0 else RCOLS, rows), idx)
        outs[name] = out
        outs[name + " live"] = (len(op._left.by_key), len(op._right.by_key))
    assert _views(outs["port"]) == _views(outs["jax"])
    assert outs["port live"] == outs["jax live"]


def test_streaming_join_requires_schemas():
    with pytest.raises(ValueError, match="declared schemas"):
        psql.StreamingJoinOperator("k", "k2", device="cpu")

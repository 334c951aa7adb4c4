"""Port parity for ``ChangelogGroupAggOperator``
(``flink_tpu_torch.operators.sql_ops``) against ``flink_tpu``'s on the CPU,
on numpy-seeded batches.

Both operators keep two f32 words per group and aggregate (double-single
sums and counts, Dekker pairs for min/max); the port's step runs as torch
ops on ``device="cpu"``, its row-order folds through ``index_add_``.  Every
emitted row (op, key, values, dtypes, order) and every snapshot word is
compared BIT FOR BIT with JAX's jitted step: across integer inputs above
2^24, signed zeros, retraction input with group deletion and re-insertion,
key growth past the initial capacity, chunked batches, the legacy and
pre-r3 snapshot layouts, and snapshots restored across the packages both
ways.  JAX's step imports nothing of ``jax.experimental``, so no shim is
needed.
"""

import numpy as np
import pytest
import torch

from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.operators import sql_ops as jsql
from flink_tpu_torch.core.batch import RecordBatch
from flink_tpu_torch.interop import (changelog_agg_snapshot_from_jax,
                                     changelog_agg_snapshot_to_jax)
from flink_tpu_torch.operators import sql_ops as psql

AGGS = {"s": ("v", "sum"), "n": (None, "count"), "mn": ("v", "min"),
        "mx": ("w", "max")}
RETRACT_AGGS = {"s": ("v", "sum"), "n": (None, "count"), "t": ("w", "sum")}
OPS = np.array(["+I", "-U", "+U", "-D"])


def _pair(aggs=AGGS, key="k", **kw):
    return (jsql.ChangelogGroupAggOperator(key, aggs, **kw),
            psql.ChangelogGroupAggOperator(key, aggs, device="cpu", **kw))


def _cell_bits(a):
    a = np.asarray(a)       # object cells by value, not by address
    return tuple(a.tolist()) if a.dtype == object else a.tobytes()


def _bits(out):
    rows = []
    for b in out:
        rows.append(tuple((c, np.asarray(b.column(c)).dtype.str,
                           _cell_bits(b.column(c)))
                          for c in b.columns))
    return rows


def _snap_bits(snap):
    out = {k: v for k, v in snap.items() if k not in ("key_index", "state")}
    if "key_index" in snap:
        out["reverse"] = _cell_bits(snap["key_index"]["reverse"])
    if "state" in snap:
        out["state"] = [(np.asarray(a).dtype.str, np.asarray(a).tobytes())
                        for a in snap["state"]]
    return out


def _batch(rng, n_keys, size, kind="normal", retract=False):
    k = rng.integers(0, n_keys, size).astype(np.int64)
    if kind == "normal":
        v = (rng.standard_normal(size) * 10.0 ** rng.integers(0, 8)
             ).astype(np.float32)
    elif kind == "wide_ints":     # integers above 2^24: Dekker pairs
        v = rng.integers(-2 ** 40, 2 ** 40, size).astype(np.float64)
    elif kind == "signed_zeros":
        v = np.where(rng.random(size) < 0.5, -0.0, 0.0)
    else:
        v = rng.random(size) * 1e6
    w = rng.standard_normal(size) * 1e5
    cols = {"k": k, "v": v, "w": w}
    if retract:
        cols["op"] = rng.choice(OPS, size)
    return cols


def _run(jop, pop, batches):
    """Feed both operators; assert every output equal; return the outputs
    (JAX's)."""
    outs = []
    for cols in batches:
        want = jop.process_batch(JaxBatch(cols))
        got = pop.process_batch(RecordBatch(cols))
        assert _bits(got) == _bits(want)
        outs.append(want)
    return outs


@pytest.mark.parametrize("kind", ["normal", "wide_ints", "signed_zeros",
                                  "uniform"])
@pytest.mark.parametrize("seed", [0, 1])
def test_append_only_rows_and_snapshots_equal_jax(kind, seed):
    rng = np.random.default_rng(seed * 10 + ["normal", "wide_ints",
                                             "signed_zeros",
                                             "uniform"].index(kind))
    jop, pop = _pair()
    n_keys = int(rng.integers(50, 3000))
    outs = _run(jop, pop, [_batch(rng, n_keys, int(rng.integers(1, 6000)),
                                  kind) for _ in range(5)])
    assert any(outs)
    assert _snap_bits(pop.snapshot_state()) == _snap_bits(jop.snapshot_state())


def test_extrema_are_exact_past_2_24():
    """Integer values above 2^24 stay exact through min/max (Dekker pairs);
    the count is exact.  The sum's per-batch partial is an f32 fold, as in
    JAX, so it is held to JAX's bits only."""
    rng = np.random.default_rng(5)
    jop, pop = _pair()
    vals = (2 ** 30 + 1 + 2 * rng.integers(0, 1000, 4000)).astype(np.float64)
    cols = {"k": np.zeros(4000, np.int64), "v": vals, "w": vals}
    out = _run(jop, pop, [cols])[0][0]
    assert out.column("mn")[0] == vals.min()
    assert out.column("mx")[0] == vals.max()
    assert out.column("n")[0] == 4000.0
    assert vals.min() > 2 ** 24 and vals.min() != np.float32(vals.min())


def test_signed_zero_in_group_zero():
    """Group 0 takes the pad rows (each adds the identity): a -0.0 there
    comes out with JAX's bits in the sums' words and the extrema's."""
    jop, pop = _pair()
    for vals in ([-0.0, -0.0, -0.0], [-0.0], [0.0, -0.0], [-0.0, 0.0, -0.0]):
        n = len(vals)
        cols = {"k": np.zeros(n, np.int64), "v": np.array(vals),
                "w": np.array(vals)}
        _run(jop, pop, [cols])
        assert _snap_bits(pop.snapshot_state()) == \
            _snap_bits(jop.snapshot_state())
    cols = {"k": np.array([7, 0, 7]), "v": np.array([-0.0, 1.0, -0.0]),
            "w": np.array([0.0, -0.0, -0.0])}
    _run(jop, pop, [cols])
    assert _snap_bits(pop.snapshot_state()) == _snap_bits(jop.snapshot_state())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_consume_retractions_equal_jax(seed):
    rng = np.random.default_rng(seed)
    jop, pop = _pair(RETRACT_AGGS, consume_retractions=True)
    n_keys = int(rng.integers(5, 400))
    outs = _run(jop, pop, [_batch(rng, n_keys, int(rng.integers(1, 3000)),
                                  "uniform", retract=True)
                           for _ in range(5)])
    ops = {o for b in outs for e in b for o in e.column("op").tolist()}
    assert {"+I", "-D", "-U", "+U"} <= ops
    assert _snap_bits(pop.snapshot_state()) == _snap_bits(jop.snapshot_state())


def test_group_deletion_and_reinsertion():
    jop, pop = _pair({"s": ("v", "sum")}, consume_retractions=True)
    feed = [
        ({"k": [1, 2, 1], "v": [1.0, 2.0, 3.0], "op": ["+I", "+I", "+I"]}),
        ({"k": [1, 2], "v": [1.0, 2.0], "op": ["-D", "-D"]}),   # 2 deleted
        ({"k": [1], "v": [3.0], "op": ["-U"]}),                 # 1 deleted
        ({"k": [2, 1], "v": [5.0, 4.0], "op": ["+U", "+I"]}),   # back
        ({"k": [3, 3], "v": [1.0, 1.0], "op": ["+I", "-D"]}),   # net 0
    ]
    outs = _run(jop, pop, [{c: np.asarray(v) for c, v in f.items()}
                           for f in feed])
    ops = [[o for e in out for o in e.column("op").tolist()] for out in outs]
    assert ops == [["+I", "+I"], ["-U", "+U", "-D"], ["-D"], ["+I", "+I"], []]
    assert "__rows" not in outs[0][0].columns


def test_refusals():
    for how in ("min", "max"):
        with pytest.raises(ValueError, match="not invertible"):
            psql.ChangelogGroupAggOperator("k", {"m": ("v", how)},
                                           consume_retractions=True,
                                           device="cpu")
    with pytest.raises(ValueError, match="unsupported changelog aggregate"):
        psql.ChangelogGroupAggOperator("k", {"m": ("v", "avg")},
                                       device="cpu")
    # string keys (the object-key slice): the changelog equals JAX's
    rng = np.random.default_rng(4)
    jop, pop = _pair()
    batches = []
    for _ in range(3):
        cols = _batch(rng, 40, 300)
        cols["k"] = np.char.add("g", cols["k"].astype(str)).astype(object)
        batches.append(cols)
    assert any(_run(jop, pop, batches))
    assert _snap_bits(pop.snapshot_state()) \
        == _snap_bits(jop.snapshot_state())


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        psql.ChangelogGroupAggOperator("k", AGGS)


def test_growth_and_chunking_equal_jax(monkeypatch):
    """Key growth from a capacity of 4 through several doublings, and
    batches cut into chunks of 1000 rows on both operators."""
    rng = np.random.default_rng(9)
    jop, pop = _pair(initial_capacity=4)
    monkeypatch.setattr(jop, "_MAX_CHUNK", 1000)
    monkeypatch.setattr(pop, "_MAX_CHUNK", 1000)
    batches = [_batch(rng, 50 * (i + 1) ** 2, 2500) for i in range(4)]
    outs = _run(jop, pop, batches)
    assert all(len(out) == 3 for out in outs)          # three chunks each
    assert pop._K == jop._K >= 800
    assert _snap_bits(pop.snapshot_state()) == _snap_bits(jop.snapshot_state())


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("retract", [False, True])
def test_snapshots_restore_across_packages(direction, retract):
    rng = np.random.default_rng(11 + retract)
    aggs = RETRACT_AGGS if retract else AGGS
    kw = {"consume_retractions": retract}
    batches = [_batch(rng, 700, 1500, "uniform", retract) for _ in range(6)]
    jop, pop = _pair(aggs, **kw)
    want = _run(jop, pop, batches)
    src = jsql.ChangelogGroupAggOperator("k", aggs, **kw) \
        if direction == "jax_to_port" \
        else psql.ChangelogGroupAggOperator("k", aggs, device="cpu", **kw)
    batch_cls = JaxBatch if direction == "jax_to_port" else RecordBatch
    for cols in batches[:3]:
        src.process_batch(batch_cls(cols))
    snap = src.snapshot_state()
    if direction == "jax_to_port":
        dst = psql.ChangelogGroupAggOperator("k", aggs, device="cpu", **kw)
        dst.restore_state(changelog_agg_snapshot_from_jax(snap))
        batch_cls = RecordBatch
    else:
        dst = jsql.ChangelogGroupAggOperator("k", aggs, **kw)
        dst.restore_state(changelog_agg_snapshot_to_jax(snap))
        batch_cls = JaxBatch
    rest = [dst.process_batch(batch_cls(cols)) for cols in batches[3:]]
    assert [_bits(o) for o in rest] == [_bits(o) for o in want[3:]]


def test_empty_and_object_key_snapshots():
    jop, pop = _pair()
    assert pop.snapshot_state() == jop.snapshot_state() == {}
    assert changelog_agg_snapshot_from_jax({}) == {}
    # object-key snapshots cross both ways since the object-key slice
    rng = np.random.default_rng(6)
    cols = _batch(rng, 20, 200)
    cols["k"] = np.char.add("g", cols["k"].astype(str)).astype(object)
    more = _batch(rng, 30, 200)
    more["k"] = np.char.add("g", more["k"].astype(str)).astype(object)
    _run(jop, pop, [cols])
    fwd = _pair()[1]
    fwd.restore_state(changelog_agg_snapshot_from_jax(jop.snapshot_state()))
    back = _pair()[0]
    back.restore_state(changelog_agg_snapshot_to_jax(pop.snapshot_state()))
    want = jop.process_batch(JaxBatch(more))
    assert _bits(fwd.process_batch(RecordBatch(more))) == _bits(want)
    assert _bits(back.process_batch(JaxBatch(more))) == _bits(want)
    with pytest.raises(ValueError, match="NoSuchIndex"):
        changelog_agg_snapshot_from_jax(
            {"key_index": {"reverse": ["a"]},
             "key_index_kind": "NoSuchIndex", "state": []})


def test_legacy_groups_restore_equals_jax():
    groups = {5: {"s": 1.5, "n": 2.0, "mn": -3.0, "mx": 7.0},
              9: {"s": 2.0 ** 30 + 1, "n": 1.0, "mn": 4.0, "mx": 4.0}}
    jop, pop = _pair()
    jop.restore_state({"groups": groups})
    pop.restore_state(changelog_agg_snapshot_from_jax({"groups": groups}))
    assert _snap_bits(pop.snapshot_state()) == _snap_bits(jop.snapshot_state())
    rng = np.random.default_rng(2)
    _run(jop, pop, [_batch(rng, 12, 40) for _ in range(2)])
    assert _snap_bits(pop.snapshot_state()) == _snap_bits(jop.snapshot_state())


def test_pre_r3_layout_restore_equals_jax():
    """The pre-r3 layout held one word for a min/max column: the restore
    inserts zero low words."""
    rng = np.random.default_rng(4)
    jop, pop = _pair()
    _run(jop, pop, [_batch(rng, 30, 200)])
    snap = jop.snapshot_state()
    st = snap["state"]
    old = dict(snap, state=[st[0], st[1], st[2], st[3], st[4], st[6]])
    j2, p2 = _pair()
    j2.restore_state(old)
    p2.restore_state(changelog_agg_snapshot_from_jax(old))
    assert _snap_bits(p2.snapshot_state()) == _snap_bits(j2.snapshot_state())
    _run(j2, p2, [_batch(rng, 40, 300) for _ in range(2)])


def test_vectorized_emit_equals_the_row_loop_on_10k_keys():
    """The port builds the changelog with array ops; JAX's
    ``process_batch`` builds it with a loop over the touched groups, one
    dict per row."""
    rng = np.random.default_rng(13)
    jop, pop = _pair()
    batches = [_batch(rng, 10_000, 20_000, "uniform") for _ in range(3)]
    for cols in batches:
        want = jop.process_batch(JaxBatch(cols))
        got = pop.process_batch(RecordBatch(cols))
        assert _bits(got) == _bits(want)
        rows = got[0]
        assert rows.column("op").dtype == np.dtype("<U2")
        assert rows.column("k").dtype == np.int64
        assert all(rows.column(c).dtype == np.float64 for c in AGGS)
    st = pop.step_stats
    assert st["steps"] == 3 and st["rows"] == 60_000
    assert st["d2h_bytes"] == 2 * 8 * 4 * st["groups"]


def test_two_level_aggregate_over_a_changelog():
    """The count-of-counts aggregate consuming the first level's
    retractions equals JAX's and ends at ``np.bincount`` of the counts."""
    rng = np.random.default_rng(17)
    j1, p1 = _pair({"n": (None, "count")})
    j2, p2 = _pair({"keys": (None, "count")}, key="n",
                   consume_retractions=True)
    all_keys = []
    for _ in range(5):
        cols = _batch(rng, 300, 500)
        all_keys.append(cols["k"])
        first = _run(j1, p1, [cols])[0]
        for b in first:
            level2 = {"op": b.column("op"),
                      "n": np.asarray(b.column("n")).astype(np.int64)}
            _run(j2, p2, [level2])
    counts = np.bincount(np.bincount(np.concatenate(all_keys)))
    snap = p2.snapshot_state()
    rev = snap["key_index"]["reverse"]
    got = snap["state"][0].astype(np.float64) + snap["state"][1]
    np.testing.assert_array_equal(got, counts[rev])

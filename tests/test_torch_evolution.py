"""Port parity for state schema evolution: ``flink_tpu_torch.state.evolution``
and the restores that use it (the heap backend's states, the window
operator's accumulator leaves) against ``flink_tpu``'s on the CPU.

Every case of ``tests/test_evolution.py`` runs on both packages with the
same inputs: verdicts, migrated rows and snapshots bit for bit, the same
error class and message on a narrowing.  The window operator's cases run
on the host tier (numpy mirror) and the device tier (CPU tensors), with the
probe off and scatter sync pinned on both packages; a snapshot written by
one package's operator under the old aggregate restores into the other's
under the new one.  The port's window operator no longer refuses
``"evolution"``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_tpu.core import batch as jbatch
from flink_tpu.core import functions as jfn
from flink_tpu.operators import window_agg as jwin
from flink_tpu.state import api as japi
from flink_tpu.state import evolution as jevo
from flink_tpu.state import heap as jheap
from flink_tpu.state import redistribute as jredist
from flink_tpu.windowing import assigners as jassign
from flink_tpu_torch import interop
from flink_tpu_torch.core import batch as pbatch
from flink_tpu_torch.core import functions as pfn
from flink_tpu_torch.operators import window_agg as pwin
from flink_tpu_torch.state import api as papi
from flink_tpu_torch.state import evolution as pevo
from flink_tpu_torch.state import heap as pheap
from flink_tpu_torch.state import redistribute as predist
from flink_tpu_torch.windowing import assigners as passign

from test_torch_heap import same

SIDES = {
    "jax": dict(batch=jbatch, fn=jfn, win=jwin, api=japi, evo=jevo,
                heap=jheap, rd=jredist, assign=jassign, f32=jnp.float32,
                i32=jnp.int32, kw={}),
    "port": dict(batch=pbatch, fn=pfn, win=pwin, api=papi, evo=pevo,
                 heap=pheap, rd=predist, assign=passign, f32=torch.float32,
                 i32=torch.int32, kw={"device": "cpu"}),
}
TIERS = {"host": dict(emit_tier="host", snapshot_source="mirror"),
         "device": dict(emit_tier="device", snapshot_source="device")}


def both(scenario, *args):
    want = scenario(SIDES["jax"], *args)
    got = scenario(SIDES["port"], *args)
    same(got, want)
    return got


def test_resolve_verdicts():
    cases = [({"kind": "value", "dtype": "int32", "shape": ()},
              {"kind": "value", "dtype": "int32", "shape": ()}),
             ({"kind": "value", "dtype": "int32", "shape": ()},
              {"kind": "value", "dtype": "int64", "shape": ()}),
             ({"kind": "value", "dtype": "int64", "shape": ()},
              {"kind": "value", "dtype": "int32", "shape": ()}),
             ({"kind": "value", "dtype": "int32", "shape": ()},
              {"kind": "list", "dtype": "int32", "shape": ()}),
             ({"kind": "value", "dtype": "float32", "shape": (2,)},
              {"kind": "value", "dtype": "float64", "shape": (3,)}),
             ({"kind": "value", "dtype": None, "shape": ()},
              {"kind": "value", "dtype": "int8", "shape": ()})]
    got = [pevo.resolve_compatibility(o, n) for o, n in cases]
    assert got == [jevo.resolve_compatibility(o, n) for o, n in cases]
    assert got[:4] == [pevo.AS_IS, pevo.AFTER_MIGRATION, pevo.INCOMPATIBLE,
                       pevo.INCOMPATIBLE]


def test_snapshot_carries_schema_and_widens_on_restore():
    def run(S):
        b = S["heap"].HeapKeyedStateBackend()
        st = b.get_state(S["api"].ValueStateDescriptor("v", dtype=np.int32,
                                                       default=0))
        st.put_rows(b.key_slots(np.array([1, 2, 3])),
                    np.array([10, 20, 30], np.int32))
        snap = b.snapshot()
        b2 = S["heap"].HeapKeyedStateBackend()
        b2.restore(snap)
        st2 = b2.get_state(S["api"].ValueStateDescriptor(
            "v", dtype=np.int64, default=0))
        return snap, st2.get_rows(b2.key_slots(np.array([1, 2, 3]))), \
            b2.snapshot()

    snap, (got, alive), _ = both(run)
    assert snap["__schema__"]["v"]["dtype"] == "int32"
    assert got.dtype == np.int64 and got.tolist() == [10, 20, 30]


def test_incompatible_restore_fails_loudly():
    msgs = {}
    for side, S in SIDES.items():
        b = S["heap"].HeapKeyedStateBackend()
        st = b.get_state(S["api"].ValueStateDescriptor("v", dtype=np.int64,
                                                       default=0))
        b.set_current_key(1)
        st.update(7)
        b2 = S["heap"].HeapKeyedStateBackend()
        b2.restore(b.snapshot())
        with pytest.raises(S["evo"].SchemaEvolutionError,
                           match="widening") as err:
            b2.get_state(S["api"].ValueStateDescriptor("v", dtype=np.int32,
                                                       default=0))
        msgs[side] = str(err.value)
    assert msgs["port"] == msgs["jax"]


def test_added_state_starts_empty():
    def run(S):
        b = S["heap"].HeapKeyedStateBackend()
        st = b.get_state(S["api"].ValueStateDescriptor("old", dtype=np.int32,
                                                       default=0))
        b.set_current_key(1)
        st.update(5)
        b2 = S["heap"].HeapKeyedStateBackend()
        b2.restore(b.snapshot())
        new = b2.get_state(S["api"].ValueStateDescriptor(
            "brand_new", dtype=np.float64, default=-1.0))
        b2.set_current_key(1)
        old = b2.get_state(S["api"].ValueStateDescriptor(
            "old", dtype=np.int32, default=0))
        return new.value(), old.value(), b2.snapshot()

    new, old, _ = both(run)
    assert new == -1.0 and old == 5


def test_schema_survives_restore_snapshot_cycle():
    def run(S):
        b = S["heap"].HeapKeyedStateBackend()
        st = b.get_state(S["api"].ValueStateDescriptor("v", dtype=np.int32,
                                                       default=0))
        b.set_current_key(1)
        st.update(3)
        b2 = S["heap"].HeapKeyedStateBackend()
        b2.restore(b.snapshot())
        return b2.snapshot()

    assert both(run)["__schema__"]["v"]["dtype"] == "int32"


# ---------------------------------------------------------------------------
# composite accumulator evolution: the window operator and the heap
# ---------------------------------------------------------------------------

def window_op(S, agg, tier, tuple_acc=True):
    kw = (dict(value_selector=lambda c: {"v": c["v"]}) if tuple_acc
          else dict(value_column="v"))
    op = S["win"].WindowAggOperator(
        S["assign"].TumblingEventTimeWindows.of(1000), agg, key_column="k",
        device_probe="off", device_sync="scatter", native_emit=False,
        pipeline_depth=0, superbatch=1, **TIERS[tier], **kw, **S["kw"])
    op.open(S["fn"].RuntimeContext())
    return op


def feed(S, op, keys, vals, ts):
    return op.process_batch(S["batch"].RecordBatch(
        {"k": np.asarray(keys, np.int64), "v": np.asarray(vals, np.float64)},
        timestamps=np.asarray(ts, np.int64)))


def fired_rows(S, op, wm=1000):
    out = op.process_watermark(S["batch"].Watermark(wm))
    rows = [r for b in out for r in b.to_rows()]
    return sorted(({k: (v.item() if hasattr(v, "item") else v)
                    for k, v in r.items()} for r in rows),
                  key=lambda r: r["k"])


def agg_v1_added(S):
    return S["fn"].TupleAggregator({"s": ("v", S["fn"].SumAggregator(
        S["f32"]))})


def agg_v2_added(S):
    return S["fn"].TupleAggregator({
        "s": ("v", S["fn"].SumAggregator(S["f32"])),
        "a": ("v", S["fn"].AvgAggregator(S["f32"]))})


def agg_v1_removed(S):
    return S["fn"].TupleAggregator({
        "s": ("v", S["fn"].SumAggregator(S["f32"])),
        "n": ("v", S["fn"].CountAggregator())})


def _old_snapshot(S, tier, make_agg, feed_rows):
    op = window_op(S, make_agg(S), tier)
    for keys, vals, ts in feed_rows:
        feed(S, op, keys, vals, ts)
    return op.snapshot_state()


def _evolved(S, tier, snap, make_agg, feed_rows):
    op = window_op(S, make_agg(S), tier)
    op.restore_state(snap)
    for keys, vals, ts in feed_rows:
        feed(S, op, keys, vals, ts)
    return fired_rows(S, op)


@pytest.mark.parametrize("tier", list(TIERS))
def test_acc_field_added_window_state(tier):
    """SUM ACC evolves to a (sum, avg) composite: the stored leaf restores
    by NAME, the added field starts at its identity."""
    def run(S):
        snap = _old_snapshot(S, tier, agg_v1_added,
                             [([1, 1], [2., 3.], [10, 20])])
        return snap, _evolved(S, tier, snap, agg_v2_added,
                              [([1], [5.], [30])])

    snap, rows = both(run)
    assert any("'s'" in e["name"] for e in snap["leaf_schema"])
    assert len(rows) == 1 and rows[0]["s"] == 10.0 and rows[0]["a"] == 5.0


@pytest.mark.parametrize("tier", list(TIERS))
def test_acc_field_removed_window_state(tier):
    def run(S):
        snap = _old_snapshot(S, tier, agg_v1_removed,
                             [([7], [4.], [100])])
        return snap, _evolved(S, tier, snap, agg_v1_added,
                              [([7], [6.], [200])])

    _, rows = both(run)
    assert rows[0]["s"] == 10.0 and set(rows[0]) >= {"k", "s"}


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_acc_evolution_across_packages(tier, direction):
    """A snapshot under the old aggregate, written by one package, restores
    into the other's operator under the new one."""
    src, dst = (("jax", "port") if direction == "jax_to_port"
                else ("port", "jax"))
    rng = np.random.default_rng(4)
    first = [(rng.integers(0, 30, 200), rng.random(200), np.sort(
        rng.integers(0, 500, 200)))]
    later = [(rng.integers(0, 30, 200), rng.random(200), np.sort(
        rng.integers(500, 999, 200)))]
    snap = _old_snapshot(SIDES[src], tier, agg_v1_added, first)
    snap = (interop.snapshot_from_jax(snap) if dst == "port"
            else interop.snapshot_to_jax(snap))
    got = _evolved(SIDES[dst], tier, snap, agg_v2_added, later)
    want = _evolved(SIDES[src], tier,
                    _old_snapshot(SIDES[src], tier, agg_v1_added, first),
                    agg_v2_added, later)
    same(got, want)


@pytest.mark.parametrize("tier", list(TIERS))
def test_acc_leaf_narrowing_rejected(tier):
    msgs = {}
    for side, S in SIDES.items():
        op = window_op(S, S["fn"].SumAggregator(S["f32"]), tier,
                       tuple_acc=False)
        feed(S, op, [1], [1.], [10])
        snap = op.snapshot_state()
        op2 = window_op(S, S["fn"].SumAggregator(S["i32"]), tier,
                        tuple_acc=False)
        with pytest.raises(S["evo"].SchemaEvolutionError,
                           match="widening") as err:
            op2.restore_state(snap)
        msgs[side] = str(err.value)
    assert msgs["port"] == msgs["jax"]


def test_evolution_refusal_is_gone():
    assert "evolution" not in pwin._LATER


def test_acc_evolution_heap_backend():
    def run(S):
        fn = S["fn"]
        b = S["heap"].HeapKeyedStateBackend()
        st = b.get_state(S["api"].AggregatingStateDescriptor(
            "agg", fn.TupleAggregator({"s": ("v", fn.SumAggregator(
                np.float32))})))
        b.set_current_key(5)
        st.add_rows(np.array([st._slot(), st._slot()]),
                    {"v": np.array([2.0, 3.0])})
        snap = b.snapshot()
        b2 = S["heap"].HeapKeyedStateBackend()
        b2.restore(snap)
        st2 = b2.get_state(S["api"].AggregatingStateDescriptor(
            "agg", fn.TupleAggregator({
                "s": ("v", fn.SumAggregator(np.float32)),
                "a": ("v", fn.AvgAggregator(np.float32))})))
        b2.set_current_key(5)
        st2.add_rows(np.array([st2._slot()]), {"v": np.array([5.0])})
        got = st2.get()
        return {k: float(v) for k, v in got.items()}, snap, b2.snapshot()

    got, _, _ = both(run)
    assert got == {"s": 10.0, "a": 5.0}


def test_aggregating_state_rescale_with_leaf_schema():
    def run(S):
        desc = lambda: S["api"].AggregatingStateDescriptor(  # noqa: E731
            "agg", S["fn"].SumAggregator(np.float32))
        b = S["heap"].HeapKeyedStateBackend()
        st = b.get_state(desc())
        for k, v in [(1, 2.0), (2, 3.0), (3, 4.0)]:
            b.set_current_key(k)
            st.add(v)
        snap = b.snapshot()
        parts = S["rd"].split_keyed_snapshot(
            snap, S["heap"].HeapKeyedStateBackend.row_fields(snap), 128, 2)
        total, per = 0.0, []
        for p in parts:
            b2 = S["heap"].HeapKeyedStateBackend()
            b2.restore(p)
            st2 = b2.get_state(desc())
            res, alive = st2.get_rows(b2.key_slots(np.array([1, 2, 3])))
            per.append((res, alive))
            total += float(res[alive].sum())
        return total, parts, per

    total, parts, _ = both(run)
    assert len(parts) == 2 and total == 9.0

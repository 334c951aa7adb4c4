"""Port parity for the heap keyed-state layer: ``flink_tpu_torch.state``
(``api``, ``heap``, ``changelog``) against ``flink_tpu.state`` on the CPU.

Every case of ``tests/test_state.py`` and the four changelog cases of
``tests/test_incremental_changelog.py`` runs as a scenario on both
packages' backends with the same numpy inputs; what each returns (rows,
presence masks, lists, maps, results) and every snapshot tree must be
equal bit for bit, dtypes included (:func:`same`).  Snapshots restore
across the packages both ways.  Scenarios use f32 aggregates where they
compare snapshots: JAX without x64 holds a 64-bit accumulator leaf as 32
bits (``interop.heap_snapshot_to_jax`` narrows the port's for JAX).

Left out, with the modules they need: ``test_state_backend_selectable_via_
config`` and ``test_unknown_backend_rejected`` (the config factory and the
DataStream API, ROADMAP item 8).  ``test_string_keys_use_object_index``
runs as ``test_string_keys_raise_the_object_key_refusal`` (the name it had
while object keys were refused): string keys through both packages'
``ObjectKeyIndex``; the changelog cases that key by strings key by integers
here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_tpu.core import functions as jfn
from flink_tpu.state import api as japi
from flink_tpu.state import changelog as jchangelog
from flink_tpu.state import heap as jheap
from flink_tpu.state import redistribute as jredist
from flink_tpu_torch import interop
from flink_tpu_torch.core import functions as pfn
from flink_tpu_torch.state import api as papi
from flink_tpu_torch.state import changelog as pchangelog
from flink_tpu_torch.state import heap as pheap
from flink_tpu_torch.state import redistribute as predist

SIDES = {
    "jax": dict(api=japi, heap=jheap, fn=jfn, cl=jchangelog, rd=jredist,
                f32=jnp.float32, f64=jnp.float64),
    "port": dict(api=papi, heap=pheap, fn=pfn, cl=pchangelog, rd=predist,
                 f32=torch.float32, f64=torch.float64),
}


def same(a, b, path="$"):
    """Deep equality, bit for bit: dicts, sequences, arrays (dtype, shape,
    bytes; object arrays element by element), descriptors by their
    fields, scalars by value and type."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), \
            (path, sorted(map(str, a)), sorted(map(str, b)))
        for k in a:
            same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), (path, type(b))
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (path, a.dtype, b.dtype, a.shape, b.shape)
        if a.dtype == object:
            for i, (x, y) in enumerate(zip(a.ravel(), b.ravel())):
                same(x, y, f"{path}[{i}]")
        else:
            assert a.tobytes() == b.tobytes(), (path, a, b)
    elif hasattr(a, "kind") and hasattr(a, "name") and hasattr(a, "ttl"):
        assert (type(a).__name__, a.name, a.dtype, a.shape, a.default) == \
            (type(b).__name__, b.name, b.dtype, b.shape, b.default), path
    elif isinstance(a, (np.generic, float, int, bool, str)) or a is None:
        assert type(np.asarray(a).dtype) is type(np.asarray(b).dtype) \
            and (a == b or (a != a and b != b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


def both(scenario, *args):
    """Run ``scenario(S, *args)`` on each package; the results must be the
    same bit for bit.  Returns the port's."""
    want = scenario(SIDES["jax"], *args)
    got = scenario(SIDES["port"], *args)
    same(got, want)
    return got


def backend(S, clock=None):
    if clock is None:
        return S["heap"].HeapKeyedStateBackend()
    return S["heap"].HeapKeyedStateBackend(clock=clock)


# ---------------------------------------------------------------------------
# the cases of tests/test_state.py
# ---------------------------------------------------------------------------

def test_value_state_scalar_roundtrip():
    def run(S):
        b = backend(S)
        st = b.get_state(S["api"].ValueStateDescriptor(
            "v", dtype=np.float64, default=0.0))
        out = []
        b.set_current_key(7)
        out.append(st.value())
        st.update(3.5)
        out.append(st.value())
        b.set_current_key(8)
        out.append(st.value())
        b.set_current_key(7)
        st.clear()
        out.append(st.value())
        return out, b.snapshot()

    vals, _ = both(run)
    assert vals == [0.0, 3.5, 0.0, 0.0]


def test_value_state_batched_rows():
    def run(S):
        b = backend(S)
        st = b.get_state(S["api"].ValueStateDescriptor(
            "v", dtype=np.int64, default=-1))
        slots = b.key_slots(np.array([10, 20, 30, 10]))
        st.put_rows(slots, np.array([1, 2, 3, 4]))
        got = st.get_rows(slots)
        other = st.get_rows(b.key_slots(np.array([99])))
        return slots, got, other, b.snapshot()

    slots, (vals, alive), (ov, oa), _ = both(run)
    assert alive.all() and vals.tolist() == [4, 2, 3, 4]
    assert not oa[0] and ov[0] == -1


def test_value_state_object_dtype():
    def run(S):
        b = backend(S)
        st = b.get_state(S["api"].ValueStateDescriptor("v"))
        b.set_current_key(1)
        st.update({"nested": [1, 2]})
        first = st.value()
        b.set_current_key(2)
        return first, st.value(), b.snapshot()

    first, second, _ = both(run)
    assert first == {"nested": [1, 2]} and second is None


def test_list_state_batched_append_groups_by_slot():
    def run(S):
        b = backend(S)
        st = b.get_state(S["api"].ListStateDescriptor("l"))
        slots = b.key_slots(np.array([1, 2, 1, 1, 2]))
        st.add_rows(slots, ["a", "b", "c", "d", "e"])
        out = [st.get_rows(b.key_slots(np.array([1, 2])))]
        b.set_current_key(1)
        st.add("z")
        out.append(st.get())
        snap = b.snapshot()
        st.update(["only"])
        out.append(st.get())
        st.clear()
        out.append(st.get())
        return out, snap

    out, _ = both(run)
    assert out == [[["a", "c", "d"], ["b", "e"]], ["a", "c", "d", "z"],
                   ["only"], []]


def test_map_state():
    def run(S):
        b = backend(S)
        st = b.get_state(S["api"].MapStateDescriptor("m"))
        b.set_current_key(5)
        out = [st.is_empty()]
        st.put("x", 1)
        st.put("y", 2)
        out += [st.get("x"), st.contains("y"), sorted(st.keys())]
        snap = b.snapshot()
        st.remove("x")
        out.append(st.contains("x"))
        b.set_current_key(6)
        out.append(st.is_empty())
        return out, snap

    out, _ = both(run)
    assert out == [True, 1, True, ["x", "y"], False, True]


def test_reducing_state_batched_fold():
    def run(S):
        b = backend(S)
        st = b.get_state(S["api"].ReducingStateDescriptor(
            "r", S["fn"].SumAggregator(S["f32"])))
        slots = b.key_slots(np.array([1, 2, 1, 1]))
        st.add_rows(slots, np.array([1.0, 10.0, 2.0, 3.0]))
        got = st.get_rows(b.key_slots(np.array([1, 2])))
        b.set_current_key(2)
        st.add(5.0)
        return got, st.get(), b.snapshot()

    (res, alive), cur, _ = both(run)
    assert alive.all() and res.tolist() == [6.0, 10.0] and cur == 15.0


def test_reducing_state_f64_values_agree():
    """An f64 sum: JAX holds it in f32 (x64 off), the port in f64; on
    values f32 holds exactly, the results agree."""
    out = {}
    for side, S in SIDES.items():
        b = backend(S)
        st = b.get_state(S["api"].ReducingStateDescriptor(
            "r", S["fn"].SumAggregator(S["f64"])))
        slots = b.key_slots(np.array([1, 2, 1, 1]))
        st.add_rows(slots, np.array([1.0, 10.0, 2.0, 3.0]))
        out[side] = st.get_rows(b.key_slots(np.array([1, 2])))[0]
    assert out["port"].dtype == np.float64
    assert out["jax"].dtype == np.float32
    np.testing.assert_array_equal(out["port"], out["jax"])


def test_aggregating_state_nontrivial_acc():
    def run(S):
        b = backend(S)
        st = b.get_state(S["api"].AggregatingStateDescriptor(
            "a", S["fn"].AvgAggregator(S["f32"])))
        slots = b.key_slots(np.array([1, 1, 2]))
        st.add_rows(slots, np.array([2.0, 4.0, 9.0]))
        got = st.get_rows(b.key_slots(np.array([1, 2])))
        b.set_current_key(1)
        return got, st.get(), b.snapshot()

    (res, alive), cur, _ = both(run)
    assert res.tolist() == [3.0, 9.0] and cur == 3.0


def test_aggregating_state_generic_combine():
    """An aggregate with no scatter kinds folds per slot through
    ``combine_leaves`` in row order (the generic path)."""
    def run(S):
        agg = S["fn"].LambdaReduce(lambda a, b: a * b + a, np.float32(0.0))
        b = backend(S)
        st = b.get_state(S["api"].AggregatingStateDescriptor("g", agg))
        rng = np.random.default_rng(5)
        slots = b.key_slots(rng.integers(0, 9, 60))
        st.add_rows(slots, rng.random(60).astype(np.float32))
        return st.get_rows(b.key_slots(np.arange(9))), b.snapshot()

    both(run)


def test_tuple_aggregate_rows():
    def run(S):
        agg = S["fn"].TupleAggregator({
            "s": ("v", S["fn"].SumAggregator(S["f32"])),
            "a": ("v", S["fn"].AvgAggregator(S["f32"])),
            "n": ("v", S["fn"].CountAggregator())})
        b = backend(S)
        st = b.get_state(S["api"].AggregatingStateDescriptor("t", agg))
        rng = np.random.default_rng(6)
        slots = b.key_slots(rng.integers(0, 20, 200))
        st.add_rows(slots, {"v": rng.random(200).astype(np.float32)})
        b.set_current_key(3)
        return st.get_rows(b.key_slots(np.arange(20))), st.get(), \
            b.snapshot()

    both(run)


def _three_states(S, b):
    v = b.get_state(S["api"].ValueStateDescriptor("v", dtype=np.float32,
                                                  default=0.0))
    lst = b.get_state(S["api"].ListStateDescriptor("l"))
    r = b.get_state(S["api"].ReducingStateDescriptor(
        "r", S["fn"].SumAggregator(S["f32"])))
    return v, lst, r


def _filled(S):
    b = backend(S)
    v, lst, r = _three_states(S, b)
    slots = b.key_slots(np.array([100, 200, 300]))
    v.put_rows(slots, np.array([1.0, 2.0, 3.0]))
    lst.add_rows(slots, ["a", "b", "c"])
    r.add_rows(np.array([slots[0], slots[0]]), np.array([5.0, 6.0]))
    return b


def _read_three(S, b):
    states = _three_states(S, b)
    b.set_current_key(200)
    out = [states[0].value(), states[1].get()]
    b.set_current_key(100)
    out.append(states[2].get())
    return out


def test_snapshot_restore_roundtrip():
    def run(S):
        snap = _filled(S).snapshot()
        b2 = backend(S)
        b2.restore(snap)
        return _read_three(S, b2), snap, b2.snapshot()

    out, _, _ = both(run)
    assert out[0] == pytest.approx(2.0) and out[1] == ["b"]
    assert out[2] == pytest.approx(11.0)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_restores_across_packages(direction):
    src, dst = (("jax", "port") if direction == "jax_to_port"
                else ("port", "jax"))
    snap = _filled(SIDES[src]).snapshot()
    if dst == "jax":
        snap = interop.heap_snapshot_to_jax(snap)
    b2 = backend(SIDES[dst])
    b2.restore(snap)
    got = _read_three(SIDES[dst], b2)
    b3 = backend(SIDES[src])
    b3.restore(_filled(SIDES[src]).snapshot())
    same(got, _read_three(SIDES[src], b3))
    # and the restored backend snapshots as the writer's does
    same(b2.snapshot(), b3.snapshot())


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_wide_accumulator_crosses_packages(direction):
    """An int64 sum (JAX: int32) crosses both ways: to JAX narrowed by
    ``heap_snapshot_to_jax``, to the port widened by the leaf schema."""
    dtypes = {"jax": jnp.int64, "port": torch.int64}
    src, dst = (("jax", "port") if direction == "jax_to_port"
                else ("port", "jax"))

    def make(side):
        S = SIDES[side]
        b = backend(S)
        st = b.get_state(S["api"].ReducingStateDescriptor(
            "r", S["fn"].SumAggregator(dtypes[side])))
        return b, st

    b, st = make(src)
    st.add_rows(b.key_slots(np.array([4, 5, 4])), np.array([7, 8, 9]))
    snap = b.snapshot()
    if dst == "jax":
        snap = interop.heap_snapshot_to_jax(snap)
    b2, st2 = make(dst)
    b2.restore(snap)
    b2.set_current_key(4)
    st2.add(1)
    res, alive = st2.get_rows(b2.key_slots(np.array([4, 5])))
    assert alive.all() and res.tolist() == [17, 8]


def test_snapshot_splits_by_key_group_for_rescale():
    def run(S):
        b = backend(S)
        v = b.get_state(S["api"].ValueStateDescriptor("v", dtype=np.int64,
                                                      default=0))
        keys = np.arange(1000, dtype=np.int64)
        v.put_rows(b.key_slots(keys), keys * 2)
        snap = b.snapshot()
        fields = S["heap"].HeapKeyedStateBackend.row_fields(snap)
        parts = S["rd"].split_keyed_snapshot(snap, fields, 128, 4)
        out, total = [], 0
        for part in parts:
            b2 = backend(S)
            v2 = b2.get_state(S["api"].ValueStateDescriptor(
                "v", dtype=np.int64, default=0))
            b2.restore(part)
            total += b2.num_keys
            ks = np.asarray(b2._index.reverse_keys()).copy()
            out.append((ks, v2.get_rows(b2.key_slots(ks))))
        merged = S["rd"].merge_keyed_snapshots(parts, fields)
        b3 = backend(S)
        b3.get_state(S["api"].ValueStateDescriptor("v", dtype=np.int64,
                                                   default=0))
        b3.restore(merged)
        return out, total, b3.num_keys, parts

    out, total, merged_n, _ = both(run)
    assert total == merged_n == 1000
    for ks, (vals, alive) in out:
        assert alive.all() and np.array_equal(vals, ks * 2)


def test_ttl_expiry_and_snapshot_cleanup():
    def run(S):
        now = [1000]
        b = backend(S, clock=lambda: now[0])
        ttl = S["api"].StateTtlConfig.new_builder(ttl_ms=100).build()
        desc = dict(dtype=np.int64, default=-1, ttl=ttl)
        st = b.get_state(S["api"].ValueStateDescriptor("v", **desc))
        b.set_current_key(1)
        st.update(42)
        out = [st.value()]
        now[0] = 1050
        out.append(st.value())
        now[0] = 1200
        out.append(st.value())
        b.set_current_key(2)
        st.update(7)
        snap = b.snapshot()
        b2 = backend(S, clock=lambda: now[0])
        st2 = b2.get_state(S["api"].ValueStateDescriptor("v", **desc))
        b2.restore(snap)
        b2.set_current_key(1)
        out.append(st2.value())
        b2.set_current_key(2)
        out.append(st2.value())
        return out, snap

    out, _ = both(run)
    assert out == [42, 42, -1, -1, 7]


def test_ttl_read_refresh():
    def run(S):
        now = [0]
        b = backend(S, clock=lambda: now[0])
        ttl = (S["api"].StateTtlConfig.new_builder(ttl_ms=100)
               .set_update_type(S["api"].UpdateType.OnReadAndWrite).build())
        st = b.get_state(S["api"].ValueStateDescriptor(
            "v", dtype=np.int64, default=-1, ttl=ttl))
        b.set_current_key(1)
        st.update(1)
        out = []
        for t in (80, 160, 300):
            now[0] = t
            out.append(st.value())
        return out, b.snapshot()

    out, _ = both(run)
    assert out == [1, 1, -1]


def test_ttl_default_clock_reads_the_module_clock(monkeypatch):
    """With no clock given, TTL reads ``state/heap.py``'s ``_now_ms`` at
    each call, so a test steers expiry by patching it."""
    now = [5000]
    monkeypatch.setattr(pheap, "_now_ms", lambda: now[0])
    b = pheap.HeapKeyedStateBackend()
    ttl = papi.StateTtlConfig.new_builder(ttl_ms=100).build()
    st = b.get_state(papi.ValueStateDescriptor("v", dtype=np.int64,
                                               default=-1, ttl=ttl))
    b.set_current_key(1)
    st.update(3)
    now[0] = 5050
    assert st.value() == 3
    now[0] = 5200
    assert st.value() == -1


def test_string_keys_raise_the_object_key_refusal():
    """``test_string_keys_use_object_index``: string keys take the object
    index in both packages (the name is from when the port refused them);
    slots, values, reverse keys and the snapshot are equal bit for bit,
    and the snapshot restores across the packages both ways."""
    def run(S):
        b = backend(S)
        st = b.get_state(S["api"].ValueStateDescriptor(
            "v", dtype=np.float64, default=0.0))
        slots = b.key_slots(np.array(["a", "b", "a"], dtype=object))
        st.put_rows(slots, np.array([1.0, 2.0, 3.0]))
        b.set_current_key("a")
        keys = b.slot_keys(b.key_slots(np.array(["a", "b"], dtype=object)))
        return (slots, st.value(), np.sort(keys), type(b._index).__name__,
                b.snapshot())
    snap = both(run)[-1]
    jsnap = run(SIDES["jax"])[-1]

    def reread(S, s):
        b = backend(S)
        st = b.get_state(S["api"].ValueStateDescriptor(
            "v", dtype=np.float64, default=0.0))
        b.restore(s)
        b.set_current_key("b")
        return st.value(), b.key_slots(np.array(["c", "a"], dtype=object))
    same(reread(SIDES["jax"], interop.heap_snapshot_to_jax(snap)),
         reread(SIDES["port"], jsnap))


def test_restore_then_snapshot_preserves_unregistered_state():
    def run(S):
        b = backend(S)
        st = b.get_state(S["api"].ValueStateDescriptor("v", dtype=np.int64,
                                                       default=0))
        b.set_current_key(1)
        st.update(42)
        b2 = backend(S)
        b2.restore(b.snapshot())
        snap2 = b2.snapshot()
        b3 = backend(S)
        b3.restore(snap2)
        st3 = b3.get_state(S["api"].ValueStateDescriptor(
            "v", dtype=np.int64, default=0))
        b3.set_current_key(1)
        return st3.value(), snap2

    value, _ = both(run)
    assert value == 42


def test_ttl_append_does_not_resurrect_expired_content():
    def run(S):
        now = [0]
        b = backend(S, clock=lambda: now[0])
        ttl = S["api"].StateTtlConfig.new_builder(ttl_ms=100).build()
        lst = b.get_state(S["api"].ListStateDescriptor("l", ttl=ttl))
        red = b.get_state(S["api"].ReducingStateDescriptor(
            "r", S["fn"].SumAggregator(S["f32"]), ttl=ttl))
        mp = b.get_state(S["api"].MapStateDescriptor("m", ttl=ttl))
        b.set_current_key(1)
        lst.add("old")
        red.add(10.0)
        mp.put("old", 1)
        now[0] = 500
        lst.add("new")
        red.add(5.0)
        mp.put("new", 2)
        return lst.get(), red.get(), dict(mp.items()), b.snapshot()

    lst, red, mp, _ = both(run)
    assert lst == ["new"] and red == 5.0 and mp == {"new": 2}


def test_random_workload_every_state_kind():
    """A longer seeded run over every state kind, with TTL, clears and
    snapshots between batches: rows and snapshots bit for bit."""
    def run(S):
        rng = np.random.default_rng(77)
        now = [0]
        b = backend(S, clock=lambda: now[0])
        ttl = S["api"].StateTtlConfig.new_builder(ttl_ms=40).build()
        v = b.get_state(S["api"].ValueStateDescriptor(
            "v", dtype=np.float32, default=0.5, ttl=ttl))
        lst = b.get_state(S["api"].ListStateDescriptor("l"))
        agg = b.get_state(S["api"].AggregatingStateDescriptor(
            "a", S["fn"].AvgAggregator(S["f32"])))
        red = b.get_state(S["api"].ReducingStateDescriptor(
            "r", S["fn"].MaxAggregator(S["f32"]), ttl=ttl))
        out = []
        for step in range(12):
            now[0] = step * 10
            keys = rng.integers(0, 200, 300)
            vals = rng.standard_normal(300).astype(np.float32)
            slots = b.key_slots(keys)
            v.put_rows(slots, vals)
            lst.add_rows(slots[:20], vals[:20].tolist())
            agg.add_rows(slots, vals)
            red.add_rows(slots, vals)
            if step % 4 == 3:
                v.clear_rows(slots[:50])
                agg.clear_rows(slots[50:80])
                out.append(b.snapshot())
            probe = b.key_slots(np.arange(0, 220, 7))
            out.append((v.get_rows(probe), agg.get_rows(probe),
                        red.get_rows(probe), lst.get_rows(probe)))
        return out

    both(run)


# ---------------------------------------------------------------------------
# the changelog cases of tests/test_incremental_changelog.py
# ---------------------------------------------------------------------------

def changelog(S, **kw):
    return S["cl"].ChangelogKeyedStateBackend(
        S["heap"].HeapKeyedStateBackend(**kw))


def test_changelog_records_and_replays():
    def run(S):
        be = changelog(S, max_parallelism=16)
        st = be.value_state("v", default=0)
        be.set_current_key(1)
        st.update(1)
        be.set_current_key(2)
        st.update(2)
        be.materialize()
        be.set_current_key(1)
        st.update(10)
        ls = be.list_state("l")
        ls.add("x")
        snap = be.snapshot()
        be2 = changelog(S, max_parallelism=16)
        be2.restore(snap)
        st2 = be2.value_state("v", default=0)
        out = []
        for k in (1, 2):
            be2.set_current_key(k)
            out.append(st2.value())
        be2.set_current_key(1)
        out.append(be2.list_state("l").get())
        return out, snap

    out, snap = both(run)
    assert snap["changelog_backend"] and len(snap["changelog"]) <= 6
    assert out == [10, 2, ["x"]]


def test_changelog_snapshot_is_cheap_after_materialize():
    def run(S):
        be = changelog(S)
        st = be.value_state("v", default=0.0)
        slots = be.key_slots(np.arange(1000))
        st.put_rows(slots, np.arange(1000.0))
        be.materialize()
        size = be.changelog_size()
        be.set_current_key(5)
        st.update(99.0)
        return size, be.snapshot()

    size, snap = both(run)
    assert size <= 1 and len(snap["changelog"]) <= 3


def test_changelog_vectorized_rows_replay():
    def run(S):
        be = changelog(S)
        rs = be.reducing_state("sum",
                               reduce_fn=S["fn"].SumAggregator(S["f32"]))
        slots = be.key_slots(np.array([3, 1, 4, 1, 5]))
        rs.add_rows(slots, np.asarray([1.0, 2.0, 3.0, 4.0, 5.0]))
        snap = be.snapshot()
        be2 = changelog(S)
        be2.restore(snap)
        rs2 = be2.reducing_state("sum",
                                 reduce_fn=S["fn"].SumAggregator(S["f32"]))
        out = []
        for k in (1, 5):
            be2.set_current_key(k)
            out.append(float(rs2.get()))
        return out, snap

    out, _ = both(run)
    assert out == [6.0, 5.0]


def test_changelog_restore_then_snapshot_keeps_deltas():
    def run(S):
        be = changelog(S)
        st = be.value_state("v", default=0)
        be.set_current_key(9)
        st.update(42)
        be2 = changelog(S)
        be2.restore(be.snapshot())
        snap2 = be2.snapshot()
        be3 = changelog(S)
        be3.restore(snap2)
        be3.set_current_key(9)
        return be3.value_state("v", default=0).value(), snap2

    value, _ = both(run)
    assert value == 42


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_changelog_snapshot_restores_across_packages(direction):
    """A materialized base and a log suffix cross over: the log's
    registrations take the restoring side's descriptors."""
    src, dst = (("jax", "port") if direction == "jax_to_port"
                else ("port", "jax"))

    def descs(S):
        return {"v": S["api"].ValueStateDescriptor("v", dtype=np.float32,
                                                   default=0.0),
                "r": S["api"].ReducingStateDescriptor(
                    "r", S["fn"].SumAggregator(S["f32"]))}

    def fill(S):
        be = changelog(S)
        d = descs(S)
        v, r = be.get_state(d["v"]), be.get_state(d["r"])
        v.put_rows(be.key_slots(np.arange(50)), np.arange(50.0))
        be.materialize()
        r.add_rows(be.key_slots(np.array([3, 60, 3])),
                   np.array([1.5, 2.5, 4.0], np.float32))
        be.set_current_key(7)
        v.update(70.0)
        return be

    def read(S, be):
        d = descs(S)
        v, r = be.get_state(d["v"]), be.get_state(d["r"])
        return (v.get_rows(be.key_slots(np.array([3, 7, 60]))),
                r.get_rows(be.key_slots(np.array([3, 60]))))

    snap = fill(SIDES[src]).snapshot()
    convert = (interop.changelog_snapshot_from_jax if dst == "port"
               else interop.changelog_snapshot_to_jax)
    be2 = changelog(SIDES[dst])
    be2.restore(convert(snap, descs(SIDES[dst])))
    same(read(SIDES[dst], be2), read(SIDES[src], fill(SIDES[src])))


def test_changelog_incremental_suffix_and_confirmation():
    """``snapshot_increment`` ships the log suffix past the last confirmed
    cut, within one materialization epoch, as JAX's does."""
    def run(S):
        be = changelog(S)
        st = be.value_state("v", default=0)
        be.set_current_key(1)
        st.update(1)
        out = [be.snapshot_increment(1)]
        be.notify_checkpoint_complete(1)
        be.set_current_key(2)
        st.update(2)
        out.append(be.snapshot_increment(2))
        be.materialize_threshold = 2
        out.append(be.snapshot_increment(3))
        return out

    out = both(run)
    assert out[0] is None and out[2] is None
    assert out[1]["kind"] == "changelog" and out[1]["log_base"] == 3

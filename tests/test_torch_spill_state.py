"""Port parity for the spill tier's keyed state: ``flink_tpu_torch.state.
spill`` (``SpillStore`` over ``csrc/spill_store.cc``'s key-value entries,
``SpillKeyedStateBackend`` and its states) against ``flink_tpu.state.spill``
over JAX's ``native/flink_native.cc`` on the CPU.

The nine cases of ``tests/test_spill_state.py`` and the spill cases of
``tests/test_memory_manager.py`` run through both packages (``both``): the
observable values must be equal, and so must the snapshots, blob for blob
(``pickle.dumps((ts, value))`` under a fixed TTL clock in both), so a
snapshot of either package restores into the other.  The aggregates are
f32 in both (JAX without x64 holds ``jnp.float64`` as f32); the port's f64
accumulators are checked on their own.

The C stores are held to each other exactly: the same operations leave the
same values, resident bytes, log bytes and dead log bytes, the same keys in
the same iteration order, and the same bytes reclaimed by ``compact``; a
store reopened after ``flush`` (the ``FSP1`` manifest) reads back every
value, in either package's directory.
"""

import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_tpu.config.config_option import Configuration as JaxConfiguration
from flink_tpu.config.options import StateOptions as JaxStateOptions
from flink_tpu.core import functions as jfn
from flink_tpu.native import SpillStore as JaxStore
from flink_tpu.native import get_lib as jax_native
from flink_tpu.operators import process as jprocess
from flink_tpu.runtime import memory as jmem
from flink_tpu.state import api as japi
from flink_tpu.state import changelog as jchangelog
from flink_tpu.state import heap as jheap
from flink_tpu.state import make_keyed_backend as jax_make_keyed_backend
from flink_tpu.state import redistribute as jredist
from flink_tpu.state import spill as jspill
from flink_tpu_torch.config.config_option import Configuration
from flink_tpu_torch.config.options import StateOptions
from flink_tpu_torch.core import functions as pfn
from flink_tpu_torch.operators import process as pprocess
from flink_tpu_torch.runtime import memory as pmem
from flink_tpu_torch.state import api as papi
from flink_tpu_torch.state import changelog as pchangelog
from flink_tpu_torch.state import heap as pheap
from flink_tpu_torch.state import make_keyed_backend
from flink_tpu_torch.state import redistribute as predist
from flink_tpu_torch.state import spill as pspill

SIDES = {
    "jax": dict(spill=jspill, heap=jheap, api=japi, fn=jfn, f32=jnp.float32,
                redist=jredist, mem=jmem, changelog=jchangelog,
                process=jprocess, Config=JaxConfiguration,
                StateOptions=JaxStateOptions, make=jax_make_keyed_backend,
                values=list),
    "port": dict(spill=pspill, heap=pheap, api=papi, fn=pfn,
                 f32=torch.float32, redist=predist, mem=pmem,
                 changelog=pchangelog, process=pprocess,
                 Config=Configuration, StateOptions=StateOptions,
                 make=make_keyed_backend, values=list),
}

#: ``values``: a value state's ``get_rows`` as a list (the values alone in
#: either package, where the heap returns (values, alive):
#: ``test_value_rows_follow_the_heap_contract``)

#: the TTL clock of every backend here: blobs carry its time
CLOCK_MS = 1_000_000


def _plain(x):
    if isinstance(x, np.ndarray) and x.dtype == object:
        return ("nd", "|O", x.shape, _plain(x.tolist()))
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return ("np", x.dtype.str, x.tobytes())
    if isinstance(x, (list, tuple)):
        return type(x).__name__, [_plain(v) for v in x]
    if isinstance(x, dict):
        return "dict", sorted((k, _plain(v)) for k, v in x.items())
    return x


def _snap_view(snap):
    """A keyed snapshot's bits: blobs as bytes, arrays as bytes."""
    out = {}
    for k, v in snap.items():
        if k == "key_index":
            out[k] = {f: _plain(np.asarray(a)) for f, a in v.items()}
        elif isinstance(v, np.ndarray) and v.dtype == object:
            out[k] = [None if b is None else bytes(b) for b in v]
        else:
            out[k] = _plain(v)
    return out


def both(case, tmp_path):
    """``case(S, directory)`` through each package; its results must be
    equal.  Returns the port's."""
    want = case(SIDES["jax"], str(tmp_path / "jax"))
    got = case(SIDES["port"], str(tmp_path / "port"))
    assert _plain(got) == _plain(want)
    return got


def _backend(S, directory, **kw):
    kw.setdefault("clock", lambda: CLOCK_MS)
    return S["spill"].SpillKeyedStateBackend(directory, **kw)


# ---------------------------------------------------------------------------
# the cases of tests/test_spill_state.py
# ---------------------------------------------------------------------------

def test_value_state(tmp_path):
    def case(S, d):
        b = _backend(S, d, mem_budget=1 << 20)
        st = b.value_state("v", default=0)
        seen = []
        b.set_current_key("alice")
        seen.append(st.value())
        st.update(42)
        seen.append(st.value())
        b.set_current_key("bob")
        seen.append(st.value())
        b.set_current_key("alice")
        seen.append(st.value())
        snap = _snap_view(b.snapshot())
        st.clear()
        seen.append(st.value())
        b.close()
        return seen, snap
    seen, _ = both(case, tmp_path)
    assert seen == [0, 42, 0, 42, 0]


def test_rows_api(tmp_path):
    def case(S, d):
        b = _backend(S, d, mem_budget=1 << 20)
        st = b.value_state("v", default=None)
        slots = b.key_slots(np.array([10, 20, 30], np.int64))
        st.put_rows(slots, ["a", "b", "c"])
        got = S["values"](st.get_rows(slots))
        st.clear_rows(slots[:1])
        after = S["values"](st.get_rows(slots))
        snap = _snap_view(b.snapshot())
        b.close()
        return got, after, snap
    got, after, _ = both(case, tmp_path)
    assert got == ["a", "b", "c"] and after == [None, "b", "c"]


def test_list_map_state(tmp_path):
    def case(S, d):
        b = _backend(S, d, mem_budget=1 << 20)
        ls = b.list_state("l")
        ms = b.map_state("m")
        b.set_current_key(7)
        ls.add(1)
        ls.add(2)
        seen = [ls.get()]
        ls.update([9])
        seen.append(ls.get())
        ms.put("x", 1)
        ms.put_all({"y": 2})
        seen.append((ms.get("x"), ms.contains("y"), ms.is_empty(),
                     sorted(ms.keys()), sorted(ms.values()),
                     sorted(ms.items())))
        ms.remove("x")
        seen.append(ms.get("x"))
        seen.append(_snap_view(b.snapshot()))
        b.close()
        return seen
    seen = both(case, tmp_path)
    assert seen[:4] == [[1, 2], [9], (1, True, False, ["x", "y"], [1, 2],
                                      [("x", 1), ("y", 2)]), None]


def test_reducing_aggregating_state(tmp_path):
    """f32 values into f32 accumulators: blob-equal snapshots.  (JAX's
    reducing state widens a loaded f32 accumulator to f64 when a Python
    float comes, by numpy's promotion; the port keeps the accumulator's
    dtype, as both heap backends do: see the next test.)"""
    def case(S, d):
        b = _backend(S, d)
        rs = b.reducing_state("r", reduce_fn=S["fn"].SumAggregator(S["f32"]))
        b.set_current_key(1)
        rs.add(np.float32(5.0))
        rs.add(np.float32(7.0))
        ag = b.aggregating_state("a", agg=S["fn"].AvgAggregator(S["f32"]))
        ag.add(10.0)
        ag.add(20.0)
        slots = b.key_slots(np.array([1, 2], np.int64))
        res, alive = ag.get_rows(slots)
        out = (rs.get(), ag.get(), float(res[0]), list(alive),
               _snap_view(b.snapshot()))
        b.close()
        return out
    r, a, first, alive, _ = both(case, tmp_path)
    assert float(r) == 12.0 and float(a) == 15.0
    assert first == 15.0 and alive == [True, False]


def test_value_rows_follow_the_heap_contract(tmp_path):
    """A spill value state's ``get_rows`` returns the values alone (an
    object array, the default where a row is absent) in both packages,
    where the heap backend returns (values, alive), so a process function
    written for the heap unpacks neither (the smoke's path 36 function
    reads both forms on path 44).  The values equal the heap's; the stored
    blobs are unchanged."""
    keys = np.array([5, 6, 7], np.int64)
    heap = pheap.HeapKeyedStateBackend()
    spill = pspill.SpillKeyedStateBackend(str(tmp_path / "p"))
    jax_spill = jspill.SpillKeyedStateBackend(str(tmp_path / "j"))
    for be, api in ((heap, papi), (spill, papi), (jax_spill, japi)):
        st = be.get_state(api.ValueStateDescriptor("n", dtype=np.int64,
                                                   default=0))
        slots = be.key_slots(keys)
        st.put_rows(slots[:2], np.array([3, 4], np.int64))
    h = heap._states["n"].get_rows(heap.key_slots(keys))
    assert [x.tolist() for x in h] == [[3, 4, 0], [True, True, False]]
    assert h[0].dtype == np.int64
    j = jax_spill._states["n"].get_rows(jax_spill.key_slots(keys))
    p = spill._states["n"].get_rows(spill.key_slots(keys))
    for got in (j, p):
        assert isinstance(got, np.ndarray) and got.dtype == object
        with pytest.raises(ValueError):
            _, _ = got                 # the heap's unpacking fails on it
    assert [int(x) for x in p] == [int(x) for x in j] == h[0].tolist()
    for be in (spill, jax_spill):
        assert be.store.get(b"n\x00" + (0).to_bytes(4, "little")) \
            is not None
    spill.close()
    jax_spill.close()


def test_python_float_values_keep_the_accumulator_dtype(tmp_path):
    """Python floats into an f32 sum: the same values in both packages; the
    port's accumulator stays f32 where JAX's becomes f64 from its second
    add on (a loaded numpy f32 row plus a numpy f64 value)."""
    out = {}
    for side, S in SIDES.items():
        b = _backend(S, str(tmp_path / side))
        rs = b.reducing_state("r", reduce_fn=S["fn"].SumAggregator(S["f32"]))
        b.set_current_key(1)
        for x in (5.0, 7.0, 0.5):
            rs.add(x)
        out[side] = rs.get()
        b.close()
    assert float(out["port"]) == float(out["jax"]) == 12.5
    assert out["port"].dtype == np.float32 and out["jax"].dtype == np.float64


def test_spill_beyond_budget(tmp_path):
    """2 MB of values under a 100 KB budget: state keeps working off disk,
    with the same resident and log bytes in both packages."""
    def case(S, d):
        b = S["spill"].SpillKeyedStateBackend(d, mem_budget=100_000)
        st = b.value_state("v")
        keys = np.arange(200, dtype=np.int64)
        slots = b.key_slots(keys)
        payload = [bytes(10_000) + str(i).encode() for i in range(200)]
        st.put_rows(slots, payload)
        out = (b.store.mem_used(), b.store.log_bytes(),
               S["values"](st.get_rows(slots)) == payload)
        b.close()
        return out
    mem, log, ok = both(case, tmp_path)
    assert mem <= 100_000 and log > 1_000_000 and ok


def test_snapshot_restore(tmp_path):
    def case(S, d):
        b = _backend(S, d + "a", mem_budget=1 << 20)
        st = b.value_state("v", default=0)
        ls = b.list_state("l")
        slots = b.key_slots(np.array([1, 2, 3], np.int64))
        st.put_rows(slots, [10, 20, 30])
        b.set_current_key(2)
        ls.add("x")
        snap = b.snapshot()
        b.close()
        b2 = _backend(S, d + "b", mem_budget=1 << 20)
        b2.restore(snap)
        st2 = b2.value_state("v", default=0)
        slots2 = b2.key_slots(np.array([1, 2, 3], np.int64))
        got = S["values"](st2.get_rows(slots2))
        b2.set_current_key(2)
        lst = b2.list_state("l").get()
        b2.close()
        return got, lst, _snap_view(snap)
    got, lst, _ = both(case, tmp_path)
    assert got == [10, 20, 30] and lst == ["x"]


def test_rescale_split_merge(tmp_path):
    """Spill snapshots go through the key-group redistribution of heap
    snapshots (``StateAssignmentOperation`` analog)."""
    def case(S, d):
        b = _backend(S, d + "a", max_parallelism=8, mem_budget=1 << 20)
        st = b.value_state("v", default=-1)
        keys = np.arange(64, dtype=np.int64)
        st.put_rows(b.key_slots(keys), [int(k) * 2 for k in keys])
        snap = b.snapshot()
        fields = S["spill"].SpillKeyedStateBackend.row_fields(snap)
        parts = S["redist"].split_keyed_snapshot(
            snap, fields, max_parallelism=8, new_parallelism=2)
        merged = S["redist"].merge_keyed_snapshots(parts, fields)
        b2 = _backend(S, d + "b", max_parallelism=8, mem_budget=1 << 20)
        b2.restore(merged)
        got = S["values"](b2.value_state("v", default=-1).get_rows(
            b2.key_slots(keys)))
        b.close()
        b2.close()
        return got, [_snap_view(p) for p in parts]
    got, _ = both(case, tmp_path)
    assert got == [int(k) * 2 for k in range(64)]


def test_ttl_expiry(tmp_path):
    def case(S, d):
        now = [1000]
        b = S["spill"].SpillKeyedStateBackend(d, clock=lambda: now[0])
        st = b.get_state(S["api"].ValueStateDescriptor(
            "v", default="dead",
            ttl=S["api"].StateTtlConfig.new_builder(100).build()))
        b.set_current_key("k")
        st.update("alive")
        seen = [st.value()]
        now[0] += 99
        seen.append(st.value())
        now[0] += 2
        seen.append(st.value())
        b.close()
        return seen
    assert both(case, tmp_path) == ["alive", "alive", "dead"]


def test_ttl_default_clock_is_the_clock_seam(tmp_path, monkeypatch):
    """Without ``clock``, TTL reads the port's clock seam at each call."""
    from flink_tpu_torch.utils import clock
    now = [5_000]
    monkeypatch.setattr(clock, "now_ms", lambda: now[0])
    b = pspill.SpillKeyedStateBackend(str(tmp_path))
    st = b.get_state(papi.ValueStateDescriptor(
        "v", default="dead", ttl=papi.StateTtlConfig.new_builder(10).build()))
    b.set_current_key(1)
    st.update("alive")
    assert pickle.loads(b.store.get(b"v\x00" + (0).to_bytes(4, "little"))) \
        == (5_000, "alive")
    now[0] = 5_009
    assert st.value() == "alive"
    now[0] = 5_010
    assert st.value() == "dead"
    b.close()


def test_parity_with_heap_backend(tmp_path):
    """The same operations on the heap and the spill backend leave the same
    observable state, in each package."""
    def case(S, d):
        heap = S["heap"].HeapKeyedStateBackend(max_parallelism=16)
        spill = S["spill"].SpillKeyedStateBackend(d, max_parallelism=16)
        rng = np.random.default_rng(3)
        keys = rng.integers(0, 20, 100)
        vals = rng.integers(0, 1000, 100).astype(np.float64)
        for be in (heap, spill):
            rs = be.reducing_state("sum",
                                   reduce_fn=S["fn"].SumAggregator(S["f32"]))
            for k, v in zip(keys.tolist(), vals.tolist()):
                be.set_current_key(k)
                rs.add(v)
        out = []
        for k in np.unique(keys).tolist():
            heap.set_current_key(k)
            spill.set_current_key(k)
            hv = float(heap._states["sum"].get())
            sv = float(spill._states["sum"].get())
            assert hv == sv, f"key {k}"
            out.append(sv)
        spill.close()
        return out
    assert both(case, tmp_path)


def test_port_f64_accumulators_keep_their_width(tmp_path):
    """An f64 aggregate (which JAX without x64 cannot hold) keeps f64 in the
    port's blobs, and sums past f32's precision exactly."""
    b = pspill.SpillKeyedStateBackend(str(tmp_path))
    rs = b.reducing_state("r", reduce_fn=pfn.SumAggregator(torch.float64))
    b.set_current_key(1)
    rs.add(2.0 ** 30)
    rs.add(0.25)
    got = rs.get()
    assert got.dtype == np.float64 and got == 2.0 ** 30 + 0.25
    b.close()


# ---------------------------------------------------------------------------
# snapshots across packages
# ---------------------------------------------------------------------------

def _fill(S, b):
    """A run of every state kind over integer keys."""
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 40, 300).astype(np.int64)
    vals = rng.random(300).astype(np.float32)
    v = b.value_state("v", default=0.0)
    ls = b.list_state("l")
    ms = b.map_state("m")
    rs = b.reducing_state("r", reduce_fn=S["fn"].SumAggregator(S["f32"]))
    ag = b.aggregating_state("a", agg=S["fn"].AvgAggregator(S["f32"]))
    for k, x in zip(keys.tolist(), vals.tolist()):
        b.set_current_key(k)
        v.update(np.float32(x))
        ls.add(np.float32(x))
        ms.put(int(k) % 3, np.float32(x))
    slots = b.key_slots(keys)
    rs.add_rows(slots, vals)
    ag.add_rows(slots, vals)
    return keys


def _read(S, b, keys):
    slots = b.key_slots(np.unique(keys))
    v = b.value_state("v", default=0.0)
    ls = b.list_state("l")
    ms = b.map_state("m")
    rs = b.reducing_state("r", reduce_fn=S["fn"].SumAggregator(S["f32"]))
    ag = b.aggregating_state("a", agg=S["fn"].AvgAggregator(S["f32"]))
    out = [S["values"](v.get_rows(slots)), ls.get_rows(slots),
           [float(x) for x in rs.get_rows(slots)[0]],
           [float(x) for x in ag.get_rows(slots)[0]]]
    maps = []
    for k in np.unique(keys).tolist():
        b.set_current_key(k)
        maps.append(sorted(ms.items()))
    return _plain(out + [maps])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshots_cross_packages_both_ways(tmp_path, writer):
    """A snapshot of every state kind, written by one package under a small
    budget (most entries in the log), restores into the other; what it
    reads equals the writer's, and its own snapshot is blob-equal."""
    reader = "port" if writer == "jax" else "jax"
    W, R = SIDES[writer], SIDES[reader]
    wb = _backend(W, str(tmp_path / "w"), mem_budget=4096)
    keys = _fill(W, wb)
    snap = wb.snapshot()
    want = _read(W, wb, keys)
    rb = _backend(R, str(tmp_path / "r"), mem_budget=4096)
    rb.restore(snap)
    assert _read(R, rb, keys) == want
    assert _snap_view(rb.snapshot()) == _snap_view(wb.snapshot())
    # and both packages write that run's snapshot blob for blob
    other = _backend(R, str(tmp_path / "o"), mem_budget=4096)
    _fill(R, other)
    assert _snap_view(other.snapshot()) == _snap_view(snap)
    for b in (wb, rb, other):
        b.close()


def test_changelog_spill_route_and_persist(tmp_path):
    """``state.backend: changelog-spill`` wraps the spill backend in both
    packages; ``persist`` and ``compact`` reach the C store."""
    def case(S, d):
        cfg = S["Config"]()
        cfg.set(S["StateOptions"].BACKEND, "changelog-spill")
        b = S["make"](cfg, directory=d)
        inner = b.inner
        assert type(inner).__name__ == "SpillKeyedStateBackend"
        st = b.value_state("v", default=0)
        b.set_current_key(3)
        st.update(11)
        b.set_current_key(3)
        inner.persist()
        out = (st.value(), inner.compact(), len(inner.store))
        b.close()
        return out
    assert both(case, tmp_path) == (11, 0, 1)


# ---------------------------------------------------------------------------
# the C store: the key-value entries against JAX's
# ---------------------------------------------------------------------------

def _ops(rng, n=4000, nk=500):
    for _ in range(n):
        k = b"key-%d" % rng.integers(0, nk)
        op = rng.integers(0, 10)
        v = bytes(rng.integers(0, 256, rng.integers(0, 300), dtype=np.uint8))
        yield op, k, v


def _stats(store, lib_garbage):
    return (len(store), store.mem_used(), store.log_bytes(), lib_garbage())


def test_c_store_equals_jax_op_for_op(tmp_path):
    js = JaxStore(str(tmp_path / "j"), 6000)
    ps = pspill.SpillStore(str(tmp_path / "p"), 6000)
    jlib = jax_native()
    jgarbage = lambda: int(jlib.spill_log_garbage(js._h))  # noqa: E731
    for op, k, v in _ops(np.random.default_rng(21)):
        if op < 6:
            js.put(k, v)
            ps.put(k, v)
        elif op < 9:
            assert ps.get(k) == js.get(k)
        else:
            assert ps.delete(k) == js.delete(k)
        assert _stats(ps, ps.log_garbage) == _stats(js, jgarbage)
    assert list(ps.keys()) == list(js.keys())
    assert ps.log_garbage() > 0 and ps.log_bytes() > ps.mem_used()
    assert ps.compact() == js.compact() > 0
    assert _stats(ps, ps.log_garbage) == _stats(js, jgarbage)
    assert ps.log_garbage() == 0
    for k in js.keys():
        assert ps.get(k) == js.get(k)
    # writes after compaction evict into the new log
    for i in range(50):
        js.put(b"late-%d" % i, bytes(200))
        ps.put(b"late-%d" % i, bytes(200))
    assert _stats(ps, ps.log_garbage) == _stats(js, jgarbage)
    assert all(ps.get(k) == js.get(k) for k in js.keys())
    js.close()
    ps.close()


@pytest.mark.parametrize("opener", ["port", "jax"])
def test_c_store_reopens_after_flush(tmp_path, opener):
    """``flush`` writes the FSP1 manifest; a store opened in the directory
    reads back every value (resident and spilled), with the resident bytes
    it had, in the port's directory by either package's store."""
    d = str(tmp_path / "s")
    ps = pspill.SpillStore(d, 3000)
    rng = np.random.default_rng(4)
    want = {}
    for op, k, v in _ops(rng, n=1500, nk=200):
        if op < 8:
            ps.put(k, v)
            want[k] = v
        else:
            ps.delete(k)
            want.pop(k, None)
    ps.flush()
    mem = ps.mem_used()
    ps.put(b"after-flush", b"not in the manifest")
    ps.close()
    with open(f"{d}/manifest.fsp", "rb") as f:
        assert f.read(4) == b"FSP1"
    re = (pspill.SpillStore if opener == "port" else JaxStore)(d, 3000)
    assert len(re) == len(want) and re.mem_used() == mem
    assert all(re.get(k) == v for k, v in want.items())
    assert re.get(b"after-flush") is None
    re.close()


def test_c_store_compact_rewrites_the_manifest(tmp_path):
    """A compaction after a flush rewrites the manifest, so a reopen reads
    the new log's offsets; ``compact`` returns the bytes reclaimed."""
    d = str(tmp_path / "s")
    ps = pspill.SpillStore(d, 1000)
    want = {}
    for i in range(100):
        want[b"k%d" % (i % 40)] = bytes([i]) * 100
        ps.put(b"k%d" % (i % 40), want[b"k%d" % (i % 40)])
    ps.flush()
    before = ps.log_bytes()
    reclaimed = ps.compact()
    assert reclaimed == before - ps.log_bytes() > 0
    ps.close()
    re = pspill.SpillStore(d, 1000)
    assert len(re) == 40
    assert all(re.get(k) == v for k, v in want.items())
    re.close()


def test_c_store_is_closed_after_close(tmp_path):
    ps = pspill.SpillStore(str(tmp_path))
    ps.put(b"a", b"b")
    ps.close()
    ps.close()                     # idempotent
    with pytest.raises(ValueError, match="closed"):
        ps.get(b"a")


# ---------------------------------------------------------------------------
# the spill cases of tests/test_memory_manager.py
# ---------------------------------------------------------------------------

@pytest.fixture(params=list(SIDES))
def side(request):
    return SIDES[request.param]


def test_spill_backend_reserves_and_releases(tmp_path, side):
    mm = side["mem"].MemoryManager(64 << 20)
    b = side["spill"].SpillKeyedStateBackend(str(tmp_path),
                                             mem_budget=16 << 20)
    b.reserve_managed(mm, owner="proc[0]")
    assert mm.used() == 16 << 20
    b.reserve_managed(mm, owner="proc[0]")   # idempotent rebind
    assert mm.used() == 16 << 20
    b.close()
    assert mm.used() == 0


def test_over_committed_slot_fails_at_open(tmp_path, side):
    mm = side["mem"].MemoryManager(20 << 20)
    b1 = side["spill"].SpillKeyedStateBackend(str(tmp_path / "a"),
                                              mem_budget=16 << 20)
    b1.reserve_managed(mm, owner="a")
    b2 = side["spill"].SpillKeyedStateBackend(str(tmp_path / "b"),
                                              mem_budget=16 << 20)
    with pytest.raises(side["mem"].MemoryReservationError):
        b2.reserve_managed(mm, owner="b")
    b1.close()
    b2.reserve_managed(mm, owner="b")        # freed share is reusable
    b2.close()


def test_pipeline_process_function_reserves_slot_memory(side):
    """A keyed process function over the configured spill backend claims
    its budget from the slot's manager at open and returns it at close."""
    cfg = side["Config"]()
    cfg.set(side["StateOptions"].BACKEND, "spill")

    class CountFn:
        def open(self, ctx):
            self.used_at_open = ctx.memory_manager.used()

        def process_batch(self, ctx, batch):
            return []

        def close(self):
            pass

    backend = side["make"](cfg)
    assert type(backend).__name__ == "SpillKeyedStateBackend"
    op = side["process"].KeyedProcessOperator(CountFn(), "k", "proc",
                                              backend=backend)
    mm = side["mem"].MemoryManager(256 << 20)
    op.open(side["fn"].RuntimeContext(task_name="proc", memory_manager=mm))
    assert mm.used() == backend.mem_budget
    op.close()
    assert mm.used() == 0


def test_changelog_wrapper_forwards_reservation(tmp_path, side):
    inner = side["spill"].SpillKeyedStateBackend(str(tmp_path),
                                                 mem_budget=8 << 20)
    wrapped = side["changelog"].ChangelogKeyedStateBackend(inner)
    mm = side["mem"].MemoryManager(16 << 20)
    wrapped.reserve_managed(mm, owner="w")
    assert mm.used() == 8 << 20
    wrapped.close()
    assert mm.used() == 0


def test_job_over_the_spill_backend_equals_jax():
    """``KeyedStream.process`` with ``state.backend: spill`` through both
    packages' environments: a running sum a key in a ``ValueState``."""
    from flink_tpu import datastream as jds
    from flink_tpu.core.batch import RecordBatch as JaxBatch
    from flink_tpu_torch import datastream as pds
    from flink_tpu_torch.core.batch import RecordBatch

    def run(S, env, RB):
        class RunningSum(S["process"].KeyedProcessFunction):
            def __init__(self):
                self.d = S["api"].ValueStateDescriptor("total", default=0.0)

            def process_batch(self, ctx, batch):
                st = ctx.state(self.d)
                u, inv = np.unique(ctx.slots, return_inverse=True)
                sums = np.bincount(inv, weights=np.asarray(batch.column("v")))
                cur = np.asarray(S["values"](st.get_rows(u)), np.float64)
                st.put_rows(u, (cur + sums).tolist())
                return [RB({"k": ctx.keys_of(u), "total": cur + sums})]

        rng = np.random.default_rng(2)
        cols = {"k": rng.integers(0, 30, 400).astype(np.int64),
                "v": rng.random(400)}
        return [dict(r) for r in env.from_collection(
            columns=cols, batch_size=64).key_by("k").process(RunningSum())
            .execute_and_collect()]

    rows = {}
    for name, mk, RB in (("jax", lambda c: jds.StreamExecutionEnvironment(
            config=c), JaxBatch), ("port", lambda c: pds.
            StreamExecutionEnvironment(config=c, device="cpu"), RecordBatch)):
        S = SIDES[name]
        cfg = S["Config"]()
        cfg.set(S["StateOptions"].BACKEND, "spill")
        rows[name] = run(S, mk(cfg), RB)
    assert _plain(rows["port"]) == _plain(rows["jax"]) and rows["port"]


def test_owned_directory_goes_at_close(tmp_path):
    """A backend given no directory logs into a temporary one of its own and
    removes it at close; a given directory stays."""
    import os
    owned = pspill.SpillKeyedStateBackend(mem_budget=16)
    owned.value_state("v").put_rows(owned.key_slots(np.arange(50)),
                                    list(range(50)))
    assert os.path.isfile(os.path.join(owned.directory, "spill.log"))
    owned.close()
    assert not os.path.exists(owned.directory)
    given = pspill.SpillKeyedStateBackend(str(tmp_path / "g"))
    given.close()
    assert os.path.isdir(tmp_path / "g")

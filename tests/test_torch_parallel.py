"""Port parity for the mesh's building blocks: ``flink_tpu_torch``'s
``core/keygroups.py``, ``state/shard_layout.py``, the keyed half of
``state/redistribute.py``, ``parallel/{mesh,exchange,ring,window_shard}.py``
and the operator's ``split_snapshot``/``merge_snapshots``, against the JAX
package's on the same seeded inputs.

The JAX side runs on the conftest's 8-device CPU mesh (``shard_map`` over
``make_mesh(D)``); the port's mesh is ``make_mesh(devices=["cpu"] * D)``:
one controller, D row blocks.  A JAX "global" array sharded over the mesh
compares with the port's D blocks concatenated.  Everything is compared
bit for bit (exact equality) unless a case says otherwise: the ring's
all-reduce of random values is held to rtol 1e-6, because JAX's ``psum``
sums in an order of its own.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_tpu.core import keygroups as jkg
from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.core.batch import Watermark as JaxWatermark
from flink_tpu.core.functions import RuntimeContext as JaxContext
from flink_tpu.core.functions import SumAggregator as JaxSum
from flink_tpu.operators.window_agg import WindowAggOperator as JaxOp
from flink_tpu.parallel import exchange as jex
from flink_tpu.parallel import mesh as jmesh
from flink_tpu.parallel import ring as jring
from flink_tpu.state import redistribute as jrd
from flink_tpu.state import shard_layout as jsl
from flink_tpu.windowing.assigners import TumblingEventTimeWindows as JaxTumbling
from flink_tpu_torch.core import keygroups as pkg
from flink_tpu_torch.core.batch import RecordBatch, Watermark
from flink_tpu_torch.core.functions import RuntimeContext, SumAggregator
from flink_tpu_torch.operators.window_agg import WindowAggOperator
from flink_tpu_torch.parallel import exchange as pex
from flink_tpu_torch.parallel import mesh as pmesh
from flink_tpu_torch.parallel import ring as pring
from flink_tpu_torch.parallel import window_shard as pws
from flink_tpu_torch.parallel.mesh_runtime import MeshWindowAggOperator
from flink_tpu_torch.state import redistribute as prd
from flink_tpu_torch.state import shard_layout as psl
from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows
from test_torch_calibration import verdicts  # noqa: F401 — the fixture


def _pmesh(D):
    return pmesh.make_mesh(devices=["cpu"] * D)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _cat(blocks):
    return np.concatenate([_np(b) for b in blocks])


# ---------------------------------------------------------------------------
# key groups
# ---------------------------------------------------------------------------

EDGE_INTS = np.array([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 12345, -987654321],
                     np.int64)


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_murmur_and_key_groups_equal_jax(dtype):
    rng = np.random.default_rng(0)
    keys = np.concatenate([EDGE_INTS.astype(dtype),
                           rng.integers(np.iinfo(dtype).min,
                                        np.iinfo(dtype).max, 5000,
                                        dtype=dtype)])
    assert np.array_equal(pkg.hash_keys(keys), jkg.hash_keys(keys))
    h = pkg.hash_keys(keys)
    assert np.array_equal(pkg.murmur_hash(h), jkg.murmur_hash(h))
    assert np.array_equal(pkg.murmur_hash(np.int32(-2 ** 31)),
                          jkg.murmur_hash(np.int32(-2 ** 31)))
    for mp in (1, 7, 128, 4096):
        assert np.array_equal(pkg.assign_to_key_group(h, mp),
                              jkg.assign_to_key_group(h, mp))
        for par in (1, 2, 3, 6, mp):
            if par > mp:
                continue
            assert np.array_equal(pkg.route_raw_keys(keys, par, mp),
                                  jkg.route_raw_keys(keys, par, mp))


def test_hash_keys_of_strings_and_composites_equal_jax():
    words = np.array(["", "a", "flink", "tpü", "key-42"] * 3, object)
    assert np.array_equal(pkg.hash_keys(words), jkg.hash_keys(words))
    comp = np.zeros(6, dtype=np.dtype((np.void, 16)))
    comp.view(np.int64)[:] = np.arange(12) * 7919 - 3
    assert np.array_equal(pkg.hash_keys(comp), jkg.hash_keys(comp))


@pytest.mark.parametrize("mp,par", [(128, 1), (128, 3), (128, 8), (7, 7),
                                    (10, 4), (4096, 6)])
def test_key_group_ranges_equal_jax(mp, par):
    got = pkg.key_group_ranges(mp, par)
    want = jkg.key_group_ranges(mp, par)
    assert [(r.start, r.end, r.num_key_groups) for r in got] == \
        [(r.start, r.end, r.num_key_groups) for r in want]
    for i in range(par):
        a = pkg.compute_key_group_range(mp, par, i)
        b = jkg.compute_key_group_range(mp, par, i)
        assert (a.start, a.end, list(a)) == (b.start, b.end, list(b))
        assert a.contains(a.start) == b.contains(b.start)
        other = pkg.KeyGroupRange(3, 5)
        assert (a.intersection(other).start, a.intersection(other).end) == \
            (b.intersection(jkg.KeyGroupRange(3, 5)).start,
             b.intersection(jkg.KeyGroupRange(3, 5)).end)
    assert (pkg.KeyGroupRange(5, 2).start, pkg.KeyGroupRange(5, 2).end) == \
        (jkg.KeyGroupRange(5, 2).start, jkg.KeyGroupRange(5, 2).end)
    with pytest.raises(ValueError, match="parallelism"):
        pkg.compute_key_group_range(4, 5, 0)


@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_key_group_sharding_equals_jax(D):
    keys = np.random.default_rng(D).integers(0, 1 << 40, 3000)
    a = pmesh.KeyGroupSharding(max_parallelism=128, num_shards=D)
    b = jmesh.KeyGroupSharding(max_parallelism=128, num_shards=D)
    assert np.array_equal(a.shard_of_key_group(np.arange(128)),
                          b.shard_of_key_group(np.arange(128)))
    assert np.array_equal(a.shard_of_keys(keys), b.shard_of_keys(keys))
    assert [(r.start, r.end) for r in a.ranges()] == \
        [(r.start, r.end) for r in b.ranges()]


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_make_mesh_takes_devices_as_given_and_never_shrinks():
    m = pmesh.make_mesh(devices=["cpu"] * 4)
    assert m.size == 4
    assert m.devices == (torch.device("cpu"),) * 4
    assert m.distinct_devices() == [torch.device("cpu")]
    assert pmesh.layout_for(m, 64) == psl.ShardLayout(4, 64)
    assert pmesh.state_sharding(m).mesh is m
    if not torch.cuda.is_available():
        # no card: a mesh of cards raises, it never moves to the CPU
        with pytest.raises(RuntimeError, match="CUDA devices"):
            pmesh.make_mesh(2)
        with pytest.raises(RuntimeError, match="CUDA devices"):
            pmesh.make_mesh()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pmesh.make_mesh(devices=["cuda:0"] * 2)
    with pytest.raises(ValueError, match="n_devices"):
        pmesh.make_mesh(3, devices=["cpu"] * 2)


def test_shard_rows_splits_like_the_row_sharding():
    m = _pmesh(4)
    x = np.arange(24).reshape(12, 2)
    blocks = pmesh.shard_rows(x, m)
    assert [b.shape for b in blocks] == [(3, 2)] * 4
    assert np.array_equal(pmesh.unshard_rows(blocks).numpy(), x)
    with pytest.raises(ValueError, match="split"):
        pmesh.shard_rows(np.zeros(10), m)


# ---------------------------------------------------------------------------
# shard layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,K,n", [(4, 64, 50), (2, 64, 64), (3, 96, 10),
                                   (4, 64, 0), (1, 16, 9)])
def test_shard_layout_split_densify_manifest_equal_jax(D, K, n):
    pl, jl = psl.ShardLayout(D, K), jsl.ShardLayout(D, K)
    assert pl.rows_per_shard == jl.rows_per_shard
    assert [pl.row_range(d) for d in range(D)] == \
        [jl.row_range(d) for d in range(D)]
    rows = np.arange(-1, K + 3)
    assert np.array_equal(pl.shard_of_rows(rows), jl.shard_of_rows(rows))
    keys = np.random.default_rng(K).integers(0, 1 << 40, 500)
    assert np.array_equal(pl.route_keys(keys), jl.route_keys(keys))
    assert [pl.key_group_range(d, 128) for d in range(D)] == \
        [jl.key_group_range(d, 128) for d in range(D)]
    rng = np.random.default_rng(n)
    dense = {"counts": rng.integers(0, 9, (n, 3)).astype(np.int32),
             "leaves": [rng.random((n, 3)).astype(np.float32)],
             "watermark": 7}
    ps = psl.split_to_shard_slices(dense, pl, 128)
    js = jsl.split_to_shard_slices(dense, jl, 128)
    assert ps[psl.LAYOUT_KEY] == js[jsl.LAYOUT_KEY]
    assert psl.slice_manifest(ps) == jsl.slice_manifest(js)
    for a, b in zip(ps[psl.SLICES_KEY], js[jsl.SLICES_KEY]):
        assert a["counts"].tobytes() == b["counts"].tobytes()
        assert a["leaves"][0].tobytes() == b["leaves"][0].tobytes()
    assert psl.has_shard_slices(ps) and not psl.has_shard_slices(dense)
    # slices in any order densify back to the dense arrays
    shuffled = dict(ps, shard_slices=ps[psl.SLICES_KEY][::-1])
    back = psl.densify_keyed_snapshot(shuffled)
    want = jsl.densify_keyed_snapshot(js)
    assert back["counts"].tobytes() == want["counts"].tobytes() \
        == dense["counts"].tobytes()
    assert back["leaves"][0].tobytes() == want["leaves"][0].tobytes()
    assert back["watermark"] == 7
    assert psl.densify_keyed_snapshot(dense) is dense


def test_shard_layout_validation_errors_equal_jax():
    for mod in (psl, jsl):
        with pytest.raises(ValueError, match="n_shards"):
            mod.ShardLayout(0, 16)
        with pytest.raises(ValueError, match="not divisible"):
            mod.ShardLayout(3, 16)
    dense = {"counts": np.zeros((50, 2), np.int32),
             "leaves": [np.zeros((50, 2), np.float32)]}
    for mod in (psl, jsl):
        snap = mod.split_to_shard_slices(dense, mod.ShardLayout(4, 64))
        gap = dict(snap, shard_slices=[s for s in snap["shard_slices"]
                                       if s["shard"] != 1])
        with pytest.raises(ValueError, match="tile"):
            mod.densify_keyed_snapshot(gap)
        short = dict(snap, shard_layout=dict(snap["shard_layout"],
                                             num_keys=60))
        with pytest.raises(ValueError, match="manifest says 60"):
            mod.densify_keyed_snapshot(short)


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,cap", [(2, 64), (4, 8), (3, 5), (8, 2)])
def test_bucket_plan_and_rows_equal_jax(D, cap):
    rng = np.random.default_rng(D * 100 + cap)
    dest = rng.integers(0, D, 40).astype(np.int32)
    vals = rng.random((40, 2)).astype(np.float32)
    po, pf, pv = pex.bucket_plan(torch.from_numpy(dest), D, cap)
    jo, jf, jv = jex.bucket_plan(jnp.asarray(dest), D, cap)
    assert np.array_equal(_np(po), np.asarray(jo))
    assert np.array_equal(_np(pf), np.asarray(jf))      # the sentinel too
    assert np.array_equal(_np(pv), np.asarray(jv))
    got = pex.bucket_rows(torch.from_numpy(vals), po, pf, D, cap, -1.0)
    want = jex.bucket_rows(jnp.asarray(vals), jo, jf, D, cap, -1.0)
    assert _np(got).tobytes() == np.asarray(want).tobytes()
    if cap * D < 40:
        assert int(np.asarray(jf).max()) == D * cap   # overflow happened


@pytest.mark.parametrize("D", [2, 4])
def test_all_to_all_exchange_routes_like_jax(D):
    B, cap = 16, 12
    rng = np.random.default_rng(D)
    keys = rng.integers(0, 1000, D * B).astype(np.int32)
    vals = rng.random(D * B).astype(np.float32)
    dest = (keys % D).astype(np.int32)
    jfn = jex.make_all_to_all_exchange(jmesh.make_mesh(D), 2, cap)
    j_rx, j_valid, j_over = jfn(jnp.asarray(dest), jnp.asarray(keys),
                                jnp.asarray(vals))
    pfn = pex.make_all_to_all_exchange(_pmesh(D), 2, cap)
    p_rx, p_valid, p_over = pfn(dest, keys, vals)
    for got, want in zip(p_rx, j_rx):
        assert _cat(got).tobytes() == np.asarray(want).tobytes()
    assert np.array_equal(_cat(p_valid), np.asarray(j_valid))
    assert np.array_equal(_cat(p_over), np.asarray(j_over))
    valid = _cat(p_valid)
    rx_keys = _cat(p_rx[0])
    assert valid.sum() == D * B
    per_dev = rx_keys.reshape(D, D * cap)
    for s in range(D):
        assert (per_dev[s][valid.reshape(D, -1)[s]] % D == s).all()


def test_exchange_overflow_reported_like_jax():
    D, cap = 4, 2
    dest = np.zeros(D * 20, np.int32)
    vals = np.arange(D * 20, dtype=np.float32)
    _, j_valid, j_over = jex.make_all_to_all_exchange(
        jmesh.make_mesh(D), 1, cap)(jnp.asarray(dest), jnp.asarray(vals))
    _, p_valid, p_over = pex.make_all_to_all_exchange(_pmesh(D), 1, cap)(
        dest, vals)
    assert np.array_equal(_cat(p_over), np.asarray(j_over))
    assert int(_cat(p_over).sum()) == D * 20 - D * cap
    assert np.array_equal(_cat(p_valid), np.asarray(j_valid))


def test_resizing_exchange_zero_loss_and_max_cap_guard():
    D, B = 4, 20
    dest = np.zeros(D * B, np.int32)
    vals = np.arange(D * B, dtype=np.float32)
    ex = pex.ResizingExchange(_pmesh(D), num_leaves=1, cap=2)
    jx = jex.ResizingExchange(jmesh.make_mesh(D), num_leaves=1, cap=2)
    rx, valid, cap_used = ex(dest, vals)
    j_rx, j_valid, j_cap = jx(jnp.asarray(dest), jnp.asarray(vals))
    assert cap_used == j_cap and cap_used >= B
    assert _cat(rx[0]).tobytes() == np.asarray(j_rx[0]).tobytes()
    got = sorted(_cat(rx[0])[_cat(valid)].tolist())
    assert got == sorted(vals.tolist())               # zero loss, no dupes
    _, valid2, cap2 = ex(dest, vals)
    assert cap2 == cap_used and int(_cat(valid2).sum()) == D * B
    small = pex.ResizingExchange(_pmesh(D), num_leaves=1, cap=2, max_cap=4)
    with pytest.raises(RuntimeError, match="overflow at max capacity"):
        small(dest, np.ones(D * B, np.float32))


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

def _sum(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _max(a, b):
    return tuple(torch.maximum(x, y) if isinstance(x, torch.Tensor)
                 else jnp.maximum(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("combine", [_sum, _max], ids=["sum", "max"])
@pytest.mark.parametrize("D", [2, 3, 8])
def test_ring_combine_equals_jax(D, combine):
    parts = np.random.default_rng(D).random((D, 5)).astype(np.float32)
    (want,) = jring.make_ring_combine(jmesh.make_mesh(D), combine, 1)(
        jnp.asarray(parts))
    (got,) = pring.make_ring_combine(_pmesh(D), combine, 1)(parts)
    assert _cat(got).tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("D", [2, 8])
def test_ring_all_reduce_sum_equals_jax(D):
    ones = np.ones((D, 3), np.float32)
    got = pring.make_ring_all_reduce_sum(_pmesh(D))(ones)
    want = jring.make_ring_all_reduce_sum(jmesh.make_mesh(D))(
        jnp.asarray(ones))
    assert _cat(got).tobytes() == np.asarray(want).tobytes()
    x = np.random.default_rng(D).random((D, 7)).astype(np.float32)
    got = pring.make_ring_all_reduce_sum(_pmesh(D))(x)
    want = jring.make_ring_all_reduce_sum(jmesh.make_mesh(D))(jnp.asarray(x))
    np.testing.assert_allclose(_cat(got), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("D,panes", [(2, 3), (4, 4), (8, 2)])
def test_sharded_pane_window_total_equals_jax(D, panes):
    state = np.random.default_rng(D).random((D, 16, panes)).astype(np.float32)
    (want,) = jring.sharded_pane_window_total(jmesh.make_mesh(D), _sum, 1)(
        jnp.asarray(state))
    (got,) = pring.sharded_pane_window_total(_pmesh(D), _sum, 1)(state)
    assert _cat(got).tobytes() == np.asarray(want).tobytes()
    np.testing.assert_allclose(_cat(got).reshape(D, 16)[0],
                               state.sum(axis=(0, 2)), rtol=1e-5)


# ---------------------------------------------------------------------------
# rescale: split and merge of keyed snapshots
# ---------------------------------------------------------------------------

def _drive(op, RB, WM, n=5, nk=700, B=900, seed=2):
    rng = np.random.default_rng(seed)
    for i in range(n):
        k = rng.integers(0, nk, B).astype(np.int64)
        v = rng.random(B).astype(np.float32)
        ts = i * 300 + np.sort(rng.integers(0, 300, B)).astype(np.int64)
        op.process_batch(RB({"k": k, "v": v}, timestamps=ts))
        op.process_watermark(WM(int(ts.max()) - 400))
    op.prepare_snapshot_pre_barrier()
    return op.snapshot_state()


def _assert_snaps_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if k == "key_index":
            assert np.array_equal(g["reverse"], w["reverse"])
        elif k in ("counts", "panes"):
            assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
        elif k == "leaves":
            assert [np.asarray(l).tobytes() for l in g] == \
                [np.asarray(l).tobytes() for l in w]
        else:
            assert g == w, k


@pytest.fixture(scope="module")
def snaps():
    jop = JaxOp(JaxTumbling.of(1000), JaxSum(jnp.float32), key_column="k",
                value_column="v", emit_tier="device",
                snapshot_source="device", device_sync="scatter",
                native_emit=False, device_probe="off")
    jop.open(JaxContext())
    pop = WindowAggOperator(TumblingEventTimeWindows.of(1000),
                            SumAggregator(), key_column="k", value_column="v",
                            emit_tier="device", snapshot_source="device",
                            device_sync="scatter", native_emit=False,
                            device_probe="off", device="cpu")
    pop.open(RuntimeContext())
    return _drive(jop, JaxBatch, JaxWatermark), _drive(pop, RecordBatch,
                                                       Watermark)


@pytest.mark.parametrize("par", [1, 2, 3, 5])
def test_split_and_merge_snapshots_equal_jax(snaps, par):
    jsnap, psnap = snaps
    pparts = WindowAggOperator.split_snapshot(psnap, 128, par)
    jparts = JaxOp.split_snapshot(jsnap, 128, par)
    assert len(pparts) == len(jparts) == par
    for g, w in zip(pparts, jparts):
        _assert_snaps_equal(g, w)
    _assert_snaps_equal(WindowAggOperator.merge_snapshots(pparts),
                        JaxOp.merge_snapshots(jparts))
    merged = WindowAggOperator.merge_snapshots(pparts)
    if par == 1:
        _assert_snaps_equal(merged, psnap)
    # the keyed helpers alone, on the module's own terms
    assert len(prd.split_keyed_snapshot(
        {"empty": True}, ("counts",), 128, par)) == par
    _assert_snaps_equal(
        prd.merge_keyed_snapshots(prd.split_keyed_snapshot(
            psnap, ("leaves", "counts"), 128, par), ("leaves", "counts")),
        jrd.merge_keyed_snapshots(jrd.split_keyed_snapshot(
            jsnap, ("leaves", "counts"), 128, par), ("leaves", "counts")))


def test_merge_of_unaligned_parts_equals_jax(snaps):
    """Parts at different pane progress (an unaligned checkpoint) expand
    onto the union pane range and resume from the slowest part."""
    jsnap, psnap = snaps
    pparts = WindowAggOperator.split_snapshot(psnap, 128, 2)
    jparts = JaxOp.split_snapshot(jsnap, 128, 2)
    for parts in (pparts, jparts):
        p = parts[1]
        p["pane_base"] += 1
        p["panes"] = np.asarray(p["panes"])[1:]
        p["counts"] = np.asarray(p["counts"])[:, 1:]
        p["leaves"] = [np.asarray(l)[:, 1:] for l in p["leaves"]]
        p["watermark"] += 500
    _assert_snaps_equal(WindowAggOperator.merge_snapshots(pparts),
                        JaxOp.merge_snapshots(jparts))


def test_split_of_a_sliced_mesh_snapshot_densifies_first(snaps, verdicts):
    verdicts(taxed=False, shards=1, super_shards=1, depth=1, probe=False)
    _, psnap = snaps
    mop = MeshWindowAggOperator(TumblingEventTimeWindows.of(1000),
                                SumAggregator(), key_column="k",
                                value_column="v", emit_tier="device",
                                snapshot_source="device", native_emit=False,
                                device_probe="off", mesh=_pmesh(4))
    mop.open(RuntimeContext())
    mop.restore_state(psnap)
    sliced = mop.snapshot_state()
    assert psl.has_shard_slices(sliced)
    for a, b in zip(WindowAggOperator.split_snapshot(sliced, 128, 3),
                    WindowAggOperator.split_snapshot(psnap, 128, 3)):
        _assert_snaps_equal(a, b)


# ---------------------------------------------------------------------------
# the operator factories
# ---------------------------------------------------------------------------

def test_sharded_state_is_actually_distributed(verdicts):
    """``tests/test_parallel.py``'s case on both packages: JAX reads a
    leaf's ``.sharding.device_set`` (8 devices); the port's sharded state
    is a list of 8 row blocks, one on each mesh position's device, and
    each block holds what JAX's shard on that device holds."""
    from flink_tpu.parallel.window_shard import \
        sharded_window_operator as jax_sharded
    from flink_tpu.testing.harness import \
        KeyedOneInputOperatorHarness as JaxHarness
    from flink_tpu_torch.testing.harness import KeyedOneInputOperatorHarness
    verdicts(taxed=False, shards=1, super_shards=1, depth=1, probe=False)
    keys = np.arange(100)
    leaves = []
    for side in ("jax", "port"):
        if side == "jax":
            op = jax_sharded(jmesh.make_mesh(8),
                             assigner=JaxTumbling.of(100),
                             agg=JaxSum(jnp.float32), key_column="k",
                             value_column="v")
            h, rb = JaxHarness(op), JaxBatch
        else:
            mesh = _pmesh(8)
            op = pws.sharded_window_operator(
                mesh, assigner=TumblingEventTimeWindows.of(100),
                agg=SumAggregator(torch.float32), key_column="k",
                value_column="v")
            h, rb = KeyedOneInputOperatorHarness(op), RecordBatch
        h.process_batch(rb({"k": keys, "v": np.ones(100, np.float32)},
                           timestamps=np.zeros(100, np.int64)))
        leaves.append(op._leaves[0])
    jleaf, leaf = leaves
    assert len(jleaf.sharding.device_set) == 8
    assert len(leaf) == mesh.size == 8
    assert [b.device for b in leaf] == list(mesh.devices)
    assert all(b.shape[0] == op._K // 8 for b in leaf)
    shards = sorted(jleaf.addressable_shards, key=lambda s: s.index[0].start)
    assert [np.asarray(s.data).tobytes() for s in shards] == \
        [b.numpy().tobytes() for b in leaf]
    assert float(sum(b.sum() for b in leaf)) == 100.0


def test_window_shard_factories_build_the_mesh_and_the_placement(verdicts):
    verdicts(taxed=False, shards=1, super_shards=1, depth=1, probe=False)
    kw = dict(assigner=TumblingEventTimeWindows.of(1000),
              agg=SumAggregator(), key_column="k", value_column="v",
              native_emit=False, device_probe="off")
    mesh = _pmesh(4)
    op = pws.sharded_window_operator(mesh, **kw)
    assert isinstance(op, MeshWindowAggOperator) and op.mesh is mesh
    place = pws.placement_sharded_window_operator(mesh, **kw)
    assert type(place) is WindowAggOperator
    assert place.sharding.mesh is mesh and place.emit_tier == "device"
    with pytest.raises(ValueError, match="emit_tier='host'"):
        pws.placement_sharded_window_operator(mesh, emit_tier="host", **kw)
    with pytest.raises(ValueError, match="unsharded"):
        from flink_tpu_torch.state.paging import PagingConfig
        pws.placement_sharded_window_operator(
            mesh, paging=PagingConfig(capacity=64), **kw)
    outs = []
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 300, 2000).astype(np.int64)
    vals = rng.random(2000).astype(np.float32)
    single = WindowAggOperator(device="cpu", **kw)
    for o in (op, place, single):
        o.open(RuntimeContext())
        out = o.process_batch(RecordBatch({"k": keys, "v": vals},
                                          timestamps=np.zeros(2000,
                                                              np.int64)))
        out += o.process_watermark(Watermark(999))
        outs.append([(np.asarray(b.column("k")).tobytes(),
                      np.asarray(b.column("result")).tobytes())
                     for b in out])
    assert outs[0] == outs[1] == outs[2] and outs[0]
    # the placement's state is four row blocks, one per position
    assert len(place._counts) == 4 and place._K % 4 == 0
    assert all(c.shape[0] == place._K // 4 for c in place._counts)

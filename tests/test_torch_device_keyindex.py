"""Port parity: the device key index, the probe and the fused probe + fold
of ``flink_tpu_torch`` against ``flink_tpu/state/device_keyindex.py``.

The JAX side of the probe is ``lax_probe`` under ``jax.jit`` (the Pallas
kernels are gated to TPU backends); the port side is ``torch_probe`` through
the ``probe`` wrapper on CPU tensors.  Slots are int32 and compared exactly.
The fused probe + fold is held to what ``pallas_probe_fold``'s docstring
names as its spec: ``lax_probe`` + ``ops.scatter.scatter_fold_counts``, run
step by step under ``jax.enable_x64``; the port's plain version runs once
over the concatenated steps.  Inputs come from seeded numpy and go to both
packages.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flink_tpu.state import device_keyindex as jdk
from flink_tpu.state.keyindex import KeyIndex as JaxKeyIndex
from flink_tpu_torch.kernels import build
from flink_tpu_torch.state import device_keyindex as tdk
from flink_tpu_torch.state.keyindex import KeyIndex


def _lax(planes, klo, khi, start):
    return np.asarray(jax.jit(jdk.lax_probe)(
        *[jnp.asarray(np.asarray(p)) for p in planes],
        jnp.asarray(klo), jnp.asarray(khi), jnp.asarray(start)))


def _torch(dki, keys):
    klo, khi, start = dki.prepare_batch(keys)
    return tdk.probe(*dki.table(), *(torch.from_numpy(a)
                                     for a in (klo, khi, start))).numpy()


def _keys(rng, n):
    return rng.integers(-2 ** 62, 2 ** 62, n).astype(np.int64)


@pytest.mark.parametrize("cap", [1 << 10, 1 << 14])
def test_split_keys_and_starts_bit_equal(rng, cap):
    keys = np.concatenate([_keys(rng, 3000),
                           np.array([0, -1, 2 ** 63 - 1, -2 ** 63], np.int64)])
    for a, b in zip(tdk.split_keys(keys), jdk.split_keys(keys)):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    a, b = tdk.probe_starts(keys, cap), jdk.probe_starts(keys, cap)
    assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)


def test_planes_equal_jax_from_same_key_index(rng):
    """Both DeviceKeyIndexes loaded from ONE KeyIndex (growth from 2^10)
    hold identical planes: same bucket placement, same slot ids."""
    ki = JaxKeyIndex()
    ki.lookup_or_insert(_keys(rng, 5000))
    port = tdk.DeviceKeyIndex(initial_capacity=1 << 10, device="cpu")
    ref = jdk.DeviceKeyIndex(initial_capacity=1 << 10)
    assert port.ensure_loaded(ki) == ref.ensure_loaded(ki) == ki.num_keys
    assert port.capacity == ref.capacity
    for p, r in zip(port.table(), ref.table()):
        assert p.dtype == torch.int32
        assert np.array_equal(p.numpy(), np.asarray(r))


def test_torch_probe_equals_lax_probe(rng):
    """Negative keys, duplicates, unseen keys; growth from cap 2^10."""
    keys = _keys(rng, 5000)
    keys = np.concatenate([keys, keys[:700]])          # duplicates
    ki = KeyIndex()
    ki.lookup_or_insert(keys)
    dki = tdk.DeviceKeyIndex(initial_capacity=1 << 10, device="cpu")
    assert dki.ensure_loaded(ki) == ki.num_keys
    unseen = rng.integers(2 ** 62, 2 ** 63 - 1, 200).astype(np.int64)
    for batch in (keys, unseen, np.concatenate([unseen, keys[:300]])):
        got = _torch(dki, batch)
        assert got.dtype == np.int32
        assert np.array_equal(got, _lax(dki.table(),
                                        *dki.prepare_batch(batch)))
        assert np.array_equal(got, ki.lookup(batch))


def test_incremental_insert_and_sticky_growth(rng):
    ki = KeyIndex()
    dki = tdk.DeviceKeyIndex(initial_capacity=1 << 10, device="cpu")
    cap_seen = []
    for wave in range(4):
        keys = rng.integers(0, 1 << 40, 2000).astype(np.int64)
        ki.lookup_or_insert(keys)
        dki.ensure_loaded(ki)
        cap_seen.append(dki.capacity)
        got = _torch(dki, keys)
        assert np.array_equal(got, ki.lookup(keys)), f"wave {wave}"
        assert np.array_equal(got, _lax(dki.table(),
                                        *dki.prepare_batch(keys)))
    # sticky pow2 high-water: never shrinks, always a power of two
    assert all(c & (c - 1) == 0 for c in cap_seen)
    assert cap_seen == sorted(cap_seen)
    assert ki.num_keys <= dki.capacity // 2


def test_keyindex_port_agrees_with_reference(rng):
    """The port's numpy KeyIndex maps the same keys to the same slot SET
    (ids may be assigned in another order than the C keydict's), and its
    restore reproduces slot ids exactly."""
    keys = _keys(rng, 4000)
    ki, ref = KeyIndex(initial_capacity=1 << 10), JaxKeyIndex()
    s, r = ki.lookup_or_insert(keys), ref.lookup_or_insert(keys)
    assert ki.num_keys == ref.num_keys
    assert np.array_equal(np.sort(ki.reverse_keys()),
                          np.sort(ref.reverse_keys()))
    assert np.array_equal(ki.reverse_keys()[s], keys)
    assert np.array_equal(ref.reverse_keys()[r], keys)
    back = KeyIndex.restore(ki.snapshot())
    assert np.array_equal(back.lookup(keys), s)


def test_probe_on_cpu_tensors_counts_no_launch(rng):
    ki = KeyIndex()
    keys = _keys(rng, 500)
    ki.lookup_or_insert(keys)
    dki = tdk.DeviceKeyIndex(device="cpu")
    dki.ensure_loaded(ki)
    before = tdk.probe.launches
    _torch(dki, keys)
    assert tdk.probe.launches == before


def test_probe_checks_its_arguments():
    z = torch.zeros(1024, dtype=torch.int32)
    k = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        tdk.probe(z, z, z, k, k, k.to(torch.int64))
    with pytest.raises(ValueError):
        tdk.probe(z[:1000], z[:1000], z[:1000], k, k, k)   # not pow2
    with pytest.raises(ValueError):
        tdk.probe(z, z, z, k, k, k[:4])                    # ragged
    with pytest.raises(ValueError):
        tdk.probe(z, z, z, k, k, torch.zeros(16, dtype=torch.int32)[::2])


def test_build_module_imports_without_nvcc(monkeypatch, tmp_path):
    """``kernels/build.py`` does nothing at import time and fails only when
    asked to build on a machine without nvcc."""
    assert build.library_path("probe.cu").endswith(".so")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("probe.cu")


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdk.DeviceKeyIndex()


def test_keyindex_numbers_new_keys_in_first_occurrence_order(rng):
    """New keys take slot ids in order of first occurrence, as the JAX
    package's C keydict assigns them: the port's ids equal the reference's,
    and one call over concatenated batches assigns what one call per batch
    would (the fused lane's host pass relies on it)."""
    batches = [np.concatenate([_keys(rng, 2000), rng.integers(0, 50, 300)])
               for _ in range(4)]
    batches[2] = np.concatenate([batches[2], batches[0][:500]])
    per, ref = KeyIndex(initial_capacity=1 << 10), JaxKeyIndex()
    for b in batches:
        assert np.array_equal(per.lookup_or_insert(b),
                              ref.lookup_or_insert(b))
    once = KeyIndex(initial_capacity=1 << 10)
    once.lookup_or_insert(np.concatenate(batches))
    assert np.array_equal(once.reverse_keys(), per.reverse_keys())


# ---------------------------------------------------------------------------
# the fused probe + ordered fold
# ---------------------------------------------------------------------------

P_FOLD = 4
#: rows per staged step; the last step folds only its first 450 rows
STEPS = (700, 500, 900, 600)
B_LAST = 450


def _fold_inputs(rng, value_kind):
    """A table of 3000 keys (growth from cap 2^10), four staged steps of
    seen, unseen and negative keys plus one hot key, and non-zero starting
    delta planes."""
    seen = _keys(rng, 3000)
    ki = KeyIndex(initial_capacity=1 << 10)
    ki.lookup_or_insert(seen)
    dki = tdk.DeviceKeyIndex(initial_capacity=1 << 10, device="cpu")
    dki.ensure_loaded(ki)
    n_cells = 4096 * P_FOLD
    steps = []
    for n in STEPS:
        keys = seen[rng.integers(0, seen.size, n)]
        keys[rng.random(n) < 0.1] = rng.integers(2 ** 62, 2 ** 63 - 1)
        keys[rng.random(n) < 0.1] = seen[7]                 # one hot key
        panes = rng.integers(0, P_FOLD, n).astype(np.int32)
        panes[keys == seen[7]] = 1                          # one hot cell
        if value_kind == "float":
            vals = (rng.standard_normal(n) * 10).astype(np.float32)
        else:
            vals = rng.integers(-1000, 1000, n).astype(np.int32)
        steps.append((*dki.prepare_batch(keys), panes, vals))
    if value_kind == "float":
        dsum = rng.standard_normal(n_cells) * 3
    else:
        dsum = rng.integers(-10 ** 6, 10 ** 6, n_cells).astype(np.int64)
    dcnt = rng.integers(0, 5, n_cells).astype(np.int32)
    return dki, steps, dsum, dcnt


def _jax_steps(dki, steps, dsum, dcnt):
    """N sequential JAX steps: ``lax_probe``, then ``scatter_fold_counts``
    of the hit rows ``k < b`` (others carry the dropped pad id)."""
    from flink_tpu.operators.window_agg import _PAD_ID
    from flink_tpu.ops.scatter import scatter_fold_counts
    tab = [jnp.asarray(p.numpy()) for p in dki.table()]
    probe_fn = jax.jit(jdk.lax_probe)
    slots = []
    with jax.enable_x64(True):
        js, jc = jnp.asarray(dsum), jnp.asarray(dcnt)
        for i, (klo, khi, start, panes, vals) in enumerate(steps):
            b = B_LAST if i == len(steps) - 1 else len(klo)
            slot = probe_fn(*tab, jnp.asarray(klo), jnp.asarray(khi),
                            jnp.asarray(start))
            hit = (jnp.arange(len(klo)) < b) & (slot >= 0)
            flat = jnp.where(hit, slot * P_FOLD + jnp.asarray(panes), _PAD_ID)
            (js,), jc = scatter_fold_counts((js,), jc, flat,
                                            (jnp.asarray(vals),), ("add",))
            slots.append(np.asarray(slot))
        return np.concatenate(slots), np.asarray(js), np.asarray(jc)


@pytest.mark.parametrize("value_kind", ["float", "int"])
def test_torch_probe_fold_equals_jax_steps(rng, value_kind):
    """One ``probe_fold`` over the four steps concatenated equals four
    sequential JAX steps: ``slot`` and ``dcnt`` exactly, ``dsum``
    bit-for-bit (f32 values into f64 planes, or i32 into i64), with rows
    past ``b``, unseen and negative keys and one hot cell."""
    dki, steps, dsum, dcnt = _fold_inputs(rng, value_kind)
    want_slot, want_sum, want_cnt = _jax_steps(dki, steps, dsum, dcnt)
    cat = [torch.from_numpy(np.concatenate(c)) for c in zip(*steps)]
    b = sum(STEPS) - (STEPS[-1] - B_LAST)
    before = tdk.probe_fold.launches
    slot, got_sum, got_cnt = tdk.probe_fold(
        *dki.table(), *cat[:4], b, cat[4], torch.from_numpy(dsum.copy()),
        torch.from_numpy(dcnt.copy()), P_FOLD)
    assert tdk.probe_fold.launches == before        # CPU: the plain version
    assert np.array_equal(slot.numpy(), want_slot)
    assert (slot.numpy() < 0).sum() > 0 and (slot.numpy() >= 0).sum() > 0
    assert np.array_equal(got_cnt.numpy(), want_cnt)
    assert (got_cnt.numpy() - dcnt).max() > 100, "no hot cell folded"
    assert got_sum.numpy().dtype == want_sum.dtype
    assert np.array_equal(got_sum.numpy().view(np.int64),
                          want_sum.view(np.int64))


@pytest.mark.parametrize("kinds,dtype,want", [
    (("add",), torch.float64, True), (("add",), torch.int64, True),
    (("add", "add"), torch.float64, False), (("min",), torch.float64, False),
    (None, torch.float64, False), (("add",), torch.float32, False),
])
def test_probe_fold_gate(kinds, dtype, want):
    """A single ``add`` leaf into f64/i64 delta planes, as JAX's gate has
    it; no size enters the gate (the TPU's VMEM budget does not apply), so
    it holds at the main path's 1M keys x 16 panes."""
    assert tdk.probe_fold_available(kinds, dtype) is want


def test_probe_fold_checks_its_arguments():
    z = torch.zeros(1024, dtype=torch.int32)
    k = torch.zeros(8, dtype=torch.int32)
    v = torch.zeros(8, dtype=torch.float32)
    s, c = torch.zeros(64, dtype=torch.float64), torch.zeros(64,
                                                             dtype=torch.int32)
    with pytest.raises(TypeError):                  # f32 delta planes
        tdk.probe_fold(z, z, z, k, k, k, k, 8, v, s.float(), c, 4)
    with pytest.raises(ValueError):                 # b past the rows
        tdk.probe_fold(z, z, z, k, k, k, k, 9, v, s, c, 4)
    with pytest.raises(ValueError):                 # dcnt not int32
        tdk.probe_fold(z, z, z, k, k, k, k, 8, v, s, c.long(), 4)
    with pytest.raises(ValueError):                 # ragged values
        tdk.probe_fold(z, z, z, k, k, k, k, 8, v[:4], s, c, 4)


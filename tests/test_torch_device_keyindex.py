"""Port parity: the device key index and probe of ``flink_tpu_torch``
against ``flink_tpu/state/device_keyindex.py``.

The JAX side of the probe is ``lax_probe`` under ``jax.jit`` (the Pallas
kernel is gated to TPU backends); the port side is ``torch_probe`` through
the ``probe`` wrapper on CPU tensors.  Slots are int32 and compared exactly.
Inputs come from seeded numpy and go to both packages.
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


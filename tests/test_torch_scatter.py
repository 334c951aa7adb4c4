"""Port parity: ``flink_tpu_torch/ops/scatter.py`` against
``flink_tpu/ops/scatter.py``.

Same seeded inputs through ``scatter_fast`` / ``scatter_fold_counts`` of both
packages: add, min and max kinds, f32 values folded into f32 and into f64
state (the delta ring's cast), repeated ids, and dropped ids (``== N``, the
padding / probe-miss id).  Exact equality on the CPU: both fold in row order.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flink_tpu.ops import scatter as jsc
from flink_tpu_torch.ops import scatter as tsc

N, B = 64, 500


def _inputs(seed, state_dtype):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N + 1, B).astype(np.int32)     # N = dropped
    ids[:20] = N
    vals = (rng.standard_normal(B) * 10).astype(np.float32)
    state = (rng.standard_normal(N) * 3).astype(state_dtype)
    counts = rng.integers(0, 5, N).astype(np.int32)
    return ids, vals, state, counts


@pytest.mark.parametrize("kind", ["add", "min", "max"])
@pytest.mark.parametrize("state_dtype", [np.float32, np.float64])
def test_scatter_fast_matches_jax(kind, state_dtype):
    ids, vals, state, _ = _inputs(3, state_dtype)
    with jax.enable_x64(True):
        want = np.asarray(jsc.scatter_fast(
            (jnp.asarray(state),), jnp.asarray(ids), (jnp.asarray(vals),),
            (kind,))[0])
    t_state = torch.from_numpy(state.copy())
    (got,) = tsc.scatter_fast((t_state,), torch.from_numpy(ids),
                              (torch.from_numpy(vals),), (kind,))
    assert got is t_state                      # folded in place
    assert got.dtype == torch.from_numpy(state).dtype
    assert want.dtype == state_dtype
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kinds", [("add",), ("add", "max"), ("min", "add")])
def test_scatter_fold_counts_matches_jax(kinds):
    ids, vals, state, counts = _inputs(5, np.float64)
    vals2 = (vals[::-1] * 0.5).copy()
    lifted = (vals, vals2)[:len(kinds)]
    states = (state, state[::-1].copy())[:len(kinds)]
    with jax.enable_x64(True):
        wl, wc = jsc.scatter_fold_counts(
            tuple(jnp.asarray(s) for s in states), jnp.asarray(counts),
            jnp.asarray(ids), tuple(jnp.asarray(v) for v in lifted), kinds)
        wl, wc = [np.asarray(l) for l in wl], np.asarray(wc)
    gl, gc = tsc.scatter_fold_counts(
        tuple(torch.from_numpy(s.copy()) for s in states),
        torch.from_numpy(counts.copy()), torch.from_numpy(ids),
        tuple(torch.from_numpy(v) for v in lifted), kinds)
    assert gc.dtype == torch.int32 and np.array_equal(gc.numpy(), wc)
    for g, w in zip(gl, wl):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("kind", ["min", "max"])
def test_dropped_ids_leave_integer_state_alone(kind):
    state = torch.tensor([5, -7, 9], dtype=torch.int32)
    ids = torch.tensor([3, 3, 3], dtype=torch.int64)     # all dropped
    vals = torch.tensor([-100, 100, 0], dtype=torch.int32)
    tsc.scatter_fast((state,), ids, (vals,), (kind,))
    assert state.tolist() == [5, -7, 9]


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown scatter kind"):
        tsc.scatter_fast((torch.zeros(4),), torch.zeros(2, dtype=torch.int64),
                         (torch.ones(2),), ("mul",))

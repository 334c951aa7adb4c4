"""Port parity for the generic fold: ``flink_tpu_torch.ops.scatter``'s
``segment_running_fold``, ``segment_fold`` and ``scatter_generic`` (and the
private ``_associative_scan`` under them) against ``flink_tpu.ops.scatter``'s
on the CPU, on numpy-seeded inputs, BIT FOR BIT.

Both sides sort stably by slot id and run the same odd/even recursion of
``lax.associative_scan``, so every segment's combines group alike and the
float bits agree; the interleave pads with zeros and adds, as JAX's does, so
a ``-0.0`` input comes out of an interleave as ``+0.0`` on both sides.  Ids
repeat, and some equal ``num_slots`` (dropped rows).  The JAX side runs
jitted, as the operators run it, with x64 on for the float64 cases.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flink_tpu.ops import scatter as jsc
from flink_tpu_torch.ops import scatter as tsc

SIZES = [1, 2, 3, 63, 64, 1000, 4096]
DTYPES = ["float32", "float64", "int32"]


def _inputs(B, dtype, seed=0):
    """Slot ids in ``[0, num_slots]`` (``num_slots`` is a dropped row),
    values with about a tenth ``-0.0`` for floats, and a state."""
    rng = np.random.default_rng([B, DTYPES.index(dtype), seed])
    num_slots = max(B // 4, 1)
    ids = rng.integers(0, num_slots + 1, B).astype(np.int32)
    if dtype == "int32":
        vals = rng.integers(-1000, 1000, B).astype(np.int32)
        state = rng.integers(-10, 10, num_slots).astype(np.int32)
    else:
        vals = (rng.standard_normal(B) * 100).astype(dtype)
        vals[rng.random(B) < 0.1] = -0.0
        state = rng.standard_normal(num_slots).astype(dtype)
        state[rng.random(num_slots) < 0.2] = -0.0
    return ids, vals, state, num_slots


def _add(a, b):
    return (a[0] + b[0],)


def _bits(a):
    a = np.asarray(a)
    return a.dtype.str, a.shape, a.tobytes()


def _jax(dtype, fn, *args):
    with jax.enable_x64(dtype == "float64"):
        out = jax.jit(fn)(*[jnp.asarray(a) for a in args])
        return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", SIZES)
def test_segment_running_fold_bit_equal_jax(B, dtype):
    ids, vals, _, _ = _inputs(B, dtype)
    jorder, jsids, jend, jprefix = _jax(
        dtype, lambda i, v: jsc.segment_running_fold(i, (v,), _add),
        ids, vals)
    order, sids, end, prefix = tsc.segment_running_fold(
        torch.from_numpy(ids), (torch.from_numpy(vals),), _add)
    assert np.array_equal(order.numpy(), jorder)
    assert np.array_equal(sids.numpy(), jsids)
    assert np.array_equal(end.numpy(), jend)
    assert _bits(prefix[0].numpy()) == _bits(jprefix[0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", SIZES)
def test_segment_fold_bit_equal_jax(B, dtype):
    ids, vals, _, num_slots = _inputs(B, dtype, seed=1)
    jsids, jend, jfolded = _jax(
        dtype, lambda i, v: jsc.segment_fold(i, (v,), _add, num_slots),
        ids, vals)
    sids, end, folded = tsc.segment_fold(
        torch.from_numpy(ids), (torch.from_numpy(vals),), _add, num_slots)
    assert np.array_equal(sids.numpy(), jsids)
    assert np.array_equal(end.numpy(), jend)
    # the segment ends hold each slot's whole fold
    assert _bits(folded[0].numpy()) == _bits(jfolded[0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", SIZES)
def test_scatter_generic_bit_equal_jax(B, dtype):
    ids, vals, state, num_slots = _inputs(B, dtype, seed=2)
    (jstate,) = _jax(dtype, lambda s, i, v: jsc.scatter_generic(
        (s,), i, (v,), _add, num_slots), state, ids, vals)
    got = torch.from_numpy(state.copy())
    out = tsc.scatter_generic((got,), torch.from_numpy(ids),
                              (torch.from_numpy(vals),), _add, num_slots)
    assert out[0] is got                       # folded in place
    assert _bits(got.numpy()) == _bits(jstate)


def _jax_pair(a, b):
    """A two-leaf accumulator with no scatter kinds: a sum and a product,
    each of whose bits show the grouping.  (A combine that multiplies and
    adds in one leaf is left out: XLA may contract it into a fused
    multiply-add, which torch's CPU ops do not.)"""
    return (a[0] + b[0], a[1] * b[1])


_port_pair = _jax_pair


@pytest.mark.parametrize("B", SIZES)
def test_two_leaf_custom_aggregate_bit_equal_jax(B):
    ids, vals, state, num_slots = _inputs(B, "float32", seed=3)
    vals2 = (1 + np.sin(vals) / 8).astype(np.float32)
    state2 = (1 + np.cos(state) / 8).astype(np.float32)
    jstate = _jax("float32", lambda s, s2, i, v, v2: jsc.scatter_generic(
        (s, s2), i, (v, v2), _jax_pair, num_slots),
        state, state2, ids, vals, vals2)
    jrun = _jax("float32", lambda i, v, v2: jsc.segment_running_fold(
        i, (v, v2), _jax_pair), ids, vals, vals2)
    got = (torch.from_numpy(state.copy()), torch.from_numpy(state2.copy()))
    tsc.scatter_generic(got, torch.from_numpy(ids),
                        (torch.from_numpy(vals), torch.from_numpy(vals2)),
                        _port_pair, num_slots)
    run = tsc.segment_running_fold(
        torch.from_numpy(ids),
        (torch.from_numpy(vals), torch.from_numpy(vals2)), _port_pair)
    for g, w in zip(got, jstate):
        assert _bits(g.numpy()) == _bits(w)
    for g, w in zip(run[3], jrun[3]):
        assert _bits(g.numpy()) == _bits(w)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("B", [1, 2, 5, 64, 1001])
def test_associative_scan_matches_jax_recursion(B, dtype):
    """The private scan alone under ``a - b``, which is not associative:
    its result names the exact tree of combines, so equal outputs mean the
    same pairing at every level of the recursion."""
    rng = np.random.default_rng(B)
    vals = rng.integers(-50, 50, B).astype(dtype)
    want = np.asarray(jax.jit(lambda v: jax.lax.associative_scan(
        jnp.subtract, v))(jnp.asarray(vals)))
    got = tsc._associative_scan(lambda a, b: [a[0] - b[0]],
                                [torch.from_numpy(vals)])[0]
    assert _bits(got.numpy()) == _bits(want)


def test_interleave_adds_like_jax():
    """``-0.0`` inputs come out of the scan's interleave as ``+0.0`` (the
    pad-and-add of JAX's ``_interleave``, first element included), where a
    strided copy would keep the sign."""
    vals = np.array([-0.0, -0.0, -0.0, -0.0, -0.0], np.float32)
    want = np.asarray(jax.lax.associative_scan(jnp.add, jnp.asarray(vals)))
    got = tsc._associative_scan(lambda a, b: [a[0] + b[0]],
                                [torch.from_numpy(vals)])[0].numpy()
    assert _bits(got) == _bits(want)
    assert not np.signbit(got).any()


@pytest.mark.parametrize("B", [3, 65, 1000, 4097])
def test_padding_to_the_staged_length_keeps_the_bits(B):
    """Dropped pad rows sort after every kept row, and the recursion's
    grouping at a position depends only on the positions before it: a batch
    padded to ``next_pow2(B)`` with the dropped id folds to the same bits as
    the batch itself."""
    ids, vals, state, num_slots = _inputs(B, "float32", seed=4)
    Bp = 1 << (B - 1).bit_length()
    pids = np.concatenate([ids, np.full(Bp - B, num_slots, np.int32)])
    pvals = np.concatenate([vals, np.zeros(Bp - B, np.float32)])
    a = torch.from_numpy(state.copy())
    b = torch.from_numpy(state.copy())
    tsc.scatter_generic((a,), torch.from_numpy(ids),
                        (torch.from_numpy(vals),), _add, num_slots)
    tsc.scatter_generic((b,), torch.from_numpy(pids),
                        (torch.from_numpy(pvals),), _add, num_slots)
    assert _bits(a.numpy()) == _bits(b.numpy())

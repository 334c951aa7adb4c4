"""Ring combine: blockwise partial aggregation rotated around the mesh
(port of ``flink_tpu/parallel/ring.py``).

The ring-attention analog for streaming state: when one logical window's
panes span several devices (the pane axis split instead of the key axis),
the window total is the monoid combine of per-device partials.  Instead of
an all-gather, partials rotate around the ring: each step copies every
position's rotating partial to its neighbour ``(d + 1) % D`` (JAX's
``lax.ppermute``) and combines it into the running accumulator; after D-1
rotations every position holds the full combine.

A "sharded" argument is a list of D row blocks, block ``d`` on
``mesh.devices[d]`` (or a global array, split by
:func:`~flink_tpu_torch.parallel.mesh.shard_rows`); results are lists of D
blocks.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from flink_tpu_torch.ops.scatter import combine_along_axis
from flink_tpu_torch.parallel.mesh import KG_AXIS, DeviceMesh, shard_rows


def _ring_fold(leaves, combine_leaves: Callable, devices) -> tuple:
    """D-1 rotations folding every position's partial into all positions.
    ``leaves``: per leaf, D blocks.  Arrival order is a per-position cyclic
    rotation, so ``combine_leaves`` must be associative AND commutative
    (the ``AggregateFunction.combine`` contract)."""
    D = len(devices)
    acc = [list(l) for l in leaves]
    rotating = [list(l) for l in leaves]
    for _ in range(D - 1):
        # position i sends to (i + 1) % D: position d now holds d - 1's
        rotating = [[blocks[(d - 1) % D].to(devices[d]) for d in range(D)]
                    for blocks in rotating]
        for d in range(D):
            merged = combine_leaves(tuple(a[d] for a in acc),
                                    tuple(r[d] for r in rotating))
            for a, m in zip(acc, merged):
                a[d] = m
    return tuple(acc)


def make_ring_combine(mesh: DeviceMesh, combine_leaves: Callable,
                      num_leaves: int, axis: str = KG_AXIS):
    """A ring combine over ``axis``: ``fn(*leaves)``, each leaf one partial
    per position (a leading device dim), returns the same structure with
    every position holding the full combine.  ``combine_leaves`` must be
    associative and commutative."""
    if axis != KG_AXIS:
        raise ValueError(f"the mesh has one axis, {KG_AXIS!r}")

    def ring(*leaves) -> tuple:
        if len(leaves) != num_leaves:
            raise ValueError(f"{len(leaves)} leaves, expected {num_leaves}")
        return _ring_fold([shard_rows(l, mesh) for l in leaves],
                          combine_leaves, mesh.devices)
    return ring


def make_ring_all_reduce_sum(mesh: DeviceMesh, axis: str = KG_AXIS):
    """Additive special case: every position gets the sum over the ring
    (JAX's ``lax.psum``)."""
    if axis != KG_AXIS:
        raise ValueError(f"the mesh has one axis, {KG_AXIS!r}")

    def allreduce(x) -> List[torch.Tensor]:
        (out,) = _ring_fold([shard_rows(x, mesh)],
                            lambda a, b: (a[0] + b[0],), mesh.devices)
        return out
    return allreduce


def sharded_pane_window_total(mesh: DeviceMesh, combine_leaves: Callable,
                              num_leaves: int, axis: str = KG_AXIS):
    """Sequence-parallel window fire: each position holds a PANE SLICE of
    the window's state ``[1, K, panes_local, ...]``; it combines its local
    panes first (JAX's pairwise order), so the ring carries ``[1, K,
    ...]``, then the ring combines the positions' partials.  Returns
    ``fn(*leaves)`` -> the combined leaves, on every position."""
    if axis != KG_AXIS:
        raise ValueError(f"the mesh has one axis, {KG_AXIS!r}")

    def body(*leaves) -> tuple:
        if len(leaves) != num_leaves:
            raise ValueError(f"{len(leaves)} leaves, expected {num_leaves}")
        blocks = [shard_rows(l, mesh) for l in leaves]
        local = [combine_along_axis(tuple(b[d] for b in blocks),
                                    combine_leaves, axis=2)
                 for d in range(mesh.size)]
        return _ring_fold([[loc[j] for loc in local]
                           for j in range(num_leaves)],
                          combine_leaves, mesh.devices)
    return body

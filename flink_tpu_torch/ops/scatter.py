"""Scatter-combine: fold a record batch into dense keyed state (port of
``flink_tpu/ops/scatter.py`` ``scatter_fast``/``scatter_fold_counts``).

JAX computes these as XLA scatters outside any Pallas kernel; here they are
``index_add_`` / ``scatter_reduce_``.  Differences from the JAX functions:

- **In place.**  JAX returns new arrays (the caller donates the old ones);
  these functions update ``state_leaves``/``flat_counts`` in place and
  return the same tensors.
- **Dropped ids.**  JAX's ``mode="drop"`` discards ids ``>= N`` (padding,
  probe misses); ``index_add_`` would raise on them.  A dropped row is
  rewritten to id 0 carrying its kind's identity (0 for add, +max for min,
  -max for max), which leaves every cell unchanged without a host sync.
- **Order.**  On CUDA, ``index_add_`` on floats uses atomics in no fixed
  order, so sums into one cell may round differently from run to run; on the
  CPU the fold runs in row order like XLA's CPU scatter.
"""

from __future__ import annotations

from typing import Sequence

import torch

#: scatter kinds an accumulator leaf may declare
SCATTER_KINDS = ("add", "min", "max")

_REDUCE = {"min": "amin", "max": "amax"}


def _identity_fill(kind: str, dtype: torch.dtype):
    if kind == "add":
        return 0
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.ndim - 1))


def scatter_fast(state_leaves, slot_ids, lifted_leaves, kinds: Sequence[str]):
    """Fold lifted [B, ...] leaves into [N, ...] state leaves in place:
    ``state[slot_ids] op= lifted`` per kind (add/min/max), ``lifted`` cast
    to the state dtype.  Ids ``>= N`` are dropped."""
    out = []
    for leaf, lifted, kind in zip(state_leaves, lifted_leaves, kinds):
        if kind not in SCATTER_KINDS:
            raise ValueError(f"unknown scatter kind {kind!r}")
        keep = slot_ids < leaf.shape[0]
        idx = torch.where(keep, slot_ids, 0).to(torch.int64)
        vals = torch.where(_bcast(keep, lifted), lifted.to(leaf.dtype),
                           _identity_fill(kind, leaf.dtype))
        if kind == "add":
            leaf.index_add_(0, idx, vals)
        else:
            leaf.scatter_reduce_(0, _bcast(idx, vals).expand_as(vals), vals,
                                 reduce=_REDUCE[kind], include_self=True)
        out.append(leaf)
    return tuple(out)


def scatter_fold_counts(flat_leaves, flat_counts, slot_ids, lifted_leaves,
                        kinds: Sequence[str]):
    """One batch's fold into FLAT ``[K*P]`` keyed state, in place: the value
    leaves scatter-combine by kind and the element counts add one per kept
    row.  Shared by the update step, the probe lane's delta fold and the
    replica catch-up, so they cannot drift arithmetically."""
    new_leaves = scatter_fast(flat_leaves, slot_ids, lifted_leaves, kinds)
    keep = slot_ids < flat_counts.shape[0]
    flat_counts.index_add_(0, torch.where(keep, slot_ids, 0).to(torch.int64),
                           keep.to(flat_counts.dtype))
    return new_leaves, flat_counts

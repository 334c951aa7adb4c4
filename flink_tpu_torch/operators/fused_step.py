"""The fused super-batch lane's host-side stager (port of
``flink_tpu/operators/fused_step.py``).

``WindowAggOperator(superbatch=N)`` parks up to N micro-batches here instead
of folding each one eagerly.  Watermarks that pass no window end leave the
stage untouched; a fire, a snapshot, any other state read, or a full stage
flushes it, and the operator advances every staged batch in one pass:

- **probe on**: the staged batches concatenate into one block of R rows and
  ONE device step probes and folds all of them: under deferred sync one
  ``probe_fold`` launch (``csrc/probe_fold.cu``).  JAX pads the batches into
  an ``[N, B]`` block and runs a ``lax.scan`` over it; no scan is needed
  here, because the device table is immutable for the whole pass (a key
  first seen mid-super-batch misses in every later step), so the N steps'
  probes are independent and their folds into the delta planes equal one
  fold over the concatenated rows in step-then-row order.
- **probe off**: the staged batches concatenate and take the plain host
  pass once.

Bit-identity contract (as in JAX): the host mirror accumulates in f64/i64,
in which f32/int contributions add exactly, so regrouping records across
batches or across the warm/miss split changes no fire digest, snapshot byte
or counter.  Per-batch probe hit/miss counts may differ.

``calibrated_superbatch``/``calibrated_super_shards`` measure the JAX
package's native C pass, which the port does not load; they stay out, and
``superbatch=0`` (auto) is refused by the operator.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from flink_tpu_torch.core.functions import (tree_leaves, tree_structure,
                                            tree_unflatten)

#: staged super-batch row bound: past this the stage flushes whatever its
#: depth (staging trades latency and memory for fewer passes)
MAX_STAGED_ROWS = 1 << 21

#: the JAX package's auto-calibration candidate depth (kept for parity; the
#: port has no calibration)
AUTO_DEPTH = 8


class SuperBatchStage:
    """Host-side stage of pending micro-batches ``(keys, panes, values, B)``.

    Single-threaded: batches are staged and flushed on the task thread."""

    __slots__ = ("batches", "rows")

    def __init__(self):
        self.batches: List[tuple] = []
        self.rows = 0

    def push(self, keys, panes, values, b: int) -> None:
        self.batches.append((keys, panes, values, b))
        self.rows += int(b)

    def take(self) -> List[tuple]:
        st, self.batches, self.rows = self.batches, [], 0
        return st

    def __bool__(self) -> bool:
        return bool(self.batches)

    def __len__(self) -> int:
        return len(self.batches)


def concat_staged(staged: List[tuple]) -> Tuple[np.ndarray, np.ndarray,
                                                object, int]:
    """Concatenate staged micro-batches into one contiguous super-batch,
    record order preserved (key inserts and per-cell folds then happen in
    the order the per-batch path used)."""
    if len(staged) == 1:
        keys, panes, values, b = staged[0]
        return keys, panes, values, int(b)
    keys = np.concatenate([s[0] for s in staged])
    panes = np.concatenate([s[1] for s in staged])
    structure = tree_structure(staged[0][2])
    per = [tree_leaves(s[2]) for s in staged]
    cat = [np.concatenate([np.asarray(p[j]) for p in per])
           for j in range(len(per[0]))]
    return (keys, panes, tree_unflatten(structure, cat),
            int(sum(s[3] for s in staged)))

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

``superbatch=0`` asks :func:`calibrated_superbatch`: one C probe + fold
pass over ``AUTO_DEPTH`` concatenated batches (the concatenation timed
with it) against ``AUTO_DEPTH`` per-batch passes, measured once a process
on the port's C host layer (``state/native_mirror.py``);
:func:`calibrated_super_shards` measures the shard count of that super pass
at its own size.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.core.functions import (tree_leaves, tree_structure,
                                            tree_unflatten)

#: staged super-batch row bound: past this the stage flushes whatever its
#: depth (staging trades latency and memory for fewer passes)
MAX_STAGED_ROWS = 1 << 21

#: auto-calibration's candidate depth (the measured A/B compares this
#: against the per-batch path; FLINK_TPU_SUPERBATCH overrides)
AUTO_DEPTH = 8

#: env override, under the JAX package's name: "<N>" pins the depth (1 =
#: off), "auto" or "" measures
_ENV = "FLINK_TPU_SUPERBATCH"

_calibrated_depth: Optional[int] = None
_calibrated_shards: Optional[int] = None
_calib_lock = threading.Lock()
#: what the last measurements read, in seconds (``t_per``, ``t_super``,
#: ``super_shard_s``: shard count -> pass time), for the chip smoke's report
last_measurement: Dict[str, object] = {}


class SuperBatchStage:
    """Host-side stage of pending micro-batches ``(keys, panes, values, B)``.

    Single-threaded by construction: batches are staged wherever the hot
    stage runs (the pipeline worker, or the task thread) and flushed there
    (depth reached) or on the task thread after a pipeline barrier; the two
    never overlap, because the task thread touches the stage only after
    the pipeline's ``flush()`` returned."""

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


# ---------------------------------------------------------------------------
# measured auto-calibration (the superbatch=0 verdict)
# ---------------------------------------------------------------------------

def _super_shards_locked() -> int:
    """Body of :func:`calibrated_super_shards`; the caller holds
    ``_calib_lock``."""
    global _calibrated_shards
    if _calibrated_shards is not None:
        return _calibrated_shards
    from flink_tpu_torch.kernels.build import host_mirror_lib
    from flink_tpu_torch.state.native_mirror import (auto_shards,
                                                     measure_fused_probe)
    auto = auto_shards()
    if auto <= 1:
        _calibrated_shards = 1
        return 1
    n_keys = 1 << 19
    B = AUTO_DEPTH << 17               # one super-batch worth of rows
    rng = np.random.default_rng(29)
    keys = rng.integers(0, n_keys, 3 * B).astype(np.int64)
    vals = rng.random(3 * B).astype(np.float32)
    timings = {s: measure_fused_probe(host_mirror_lib(), s, n_keys, B, keys,
                                      vals)
               for s in (1, auto)}
    last_measurement["super_shard_s"] = timings
    _calibrated_shards = min(timings, key=timings.get)
    return _calibrated_shards


def calibrated_super_shards() -> int:
    """Shard count of the SUPER-batch C pass, measured at super-batch size
    and cached process-wide: ``calibrated_shards`` measures one
    micro-batch, where waking the thread pool can eat the win; a
    super-batch spreads that wake over N times the rows."""
    if _calibrated_shards is not None:
        return _calibrated_shards
    with _calib_lock:
        return _super_shards_locked()


def calibrated_superbatch() -> int:
    """The MEASURED super-batch depth, cached process-wide: does ONE C probe
    + fold pass over ``AUTO_DEPTH`` concatenated micro-batches (at the
    super-batch shard count) beat ``AUTO_DEPTH`` per-batch passes at the
    per-batch shard count?  Returns the depth to stage (1 = staging off).
    ``FLINK_TPU_SUPERBATCH`` pins the verdict without measuring."""
    global _calibrated_depth
    if _calibrated_depth is not None:
        return _calibrated_depth
    with _calib_lock:
        if _calibrated_depth is not None:
            return _calibrated_depth
        env = os.environ.get(_ENV, "").strip().lower()
        if env and env != "auto":
            try:
                _calibrated_depth = max(1, int(env))
                return _calibrated_depth
            except ValueError:
                pass
        _calibrated_depth = _measure_superbatch()
        return _calibrated_depth


def _measure_superbatch() -> int:
    """The A/B at the headline batch geometry (a toy super-batch fits the
    last-level cache and hides the staging copies' memory traffic).  Runs
    under ``_calib_lock``: it takes the LOCKED shard helper, since the lock
    is not reentrant and the public wrapper would deadlock."""
    from flink_tpu_torch.kernels.build import host_mirror_lib
    from flink_tpu_torch.state.native_mirror import (calibrated_shards,
                                                     measure_fused_probe)
    lib = host_mirror_lib()
    n_keys = 1 << 19
    B = 1 << 17
    N = AUTO_DEPTH
    rng = np.random.default_rng(31)
    keys = rng.integers(0, n_keys, 3 * N * B).astype(np.int64)
    vals = rng.random(3 * N * B).astype(np.float32)
    # per-batch side: one B-row pass at the per-batch shard count, times N
    t_per = measure_fused_probe(lib, calibrated_shards(), n_keys, B,
                                keys[:3 * B], vals[:3 * B]) * N
    # super side end to end: the staging concatenation (N-1 extra copies of
    # every staged column) is part of the lane's cost
    t0 = time.perf_counter()
    np.concatenate([keys[i * B:(i + 1) * B] for i in range(N)])
    np.concatenate([np.zeros(B, np.int64) for _ in range(N)])
    np.concatenate([vals[i * B:(i + 1) * B] for i in range(N)])
    t_concat = time.perf_counter() - t0
    t_super = measure_fused_probe(lib, _super_shards_locked(), n_keys,
                                  N * B, keys, vals) + t_concat
    last_measurement.update(t_per=t_per, t_super=t_super)
    # <=: a tie goes to staging (the per-batch glue it saves is upside)
    return N if t_super <= t_per else 1


def _reset_calibration_for_tests() -> None:
    """Drop the process-wide verdicts (tests, the chip smoke)."""
    global _calibrated_depth, _calibrated_shards
    with _calib_lock:
        _calibrated_depth = None
        _calibrated_shards = None
        last_measurement.clear()

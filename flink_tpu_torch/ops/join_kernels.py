"""Device equi-join: sorted-merge pair enumeration (port of
``flink_tpu/ops/join_kernels.py``).

The right keys are sorted on the device (stable, so equal keys keep their
row order), each left row's matching span is bounded by two binary searches,
and every cross pair is enumerated by a prefix-sum expansion: no Python loop
over keys.  JAX computes this as two jitted steps of XLA ops outside any
Pallas kernel; here they are torch ops on the keys' device, with JAX's
two-function contract kept so the two can be held together step by step:

- :func:`pair_count` (JAX's ``_pair_count``): the exact number of pairs;
- :func:`pair_emit` (``_pair_emit``): ``(left_idx[cap], right_idx[cap], n)``
  in left-major order, each left row's matches in the right side's stable
  sort order (ascending right row), padded with -1;
- :func:`device_join_pairs`: the contract of ``operators/joins._join_pairs``
  (int64 index pairs; empties give two empty arrays) on a device.

JAX factorizes the keys to dense codes first only because ``jnp`` is 32-bit
there; the pairs do not depend on the code values (a left row's matches all
share its key and come out in ascending right row), so the port sorts the
raw int64 keys.  Keys that are not integers are factorized first, as JAX's
are (:func:`join_codes`, through ``state/keyindex.py`` ``ObjectKeyIndex``),
so the card still sorts dense int64 codes.

CUDA tensors run the torch ops; CPU tensors take the plain version
(:func:`plain_pair_spans`, :func:`plain_pair_expand`: numpy, the expansion
by ``np.repeat``).  :func:`spans` and :func:`expand` are the torch ops
themselves, on any device, for the tests.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from flink_tpu_torch import DeviceLike, resolve_device
from flink_tpu_torch.ops.shapes import quantize_pow2
from flink_tpu_torch.state.keyindex import ObjectKeyIndex


def _int_column(keys):
    """``keys`` as a contiguous int64 array, or None when they are not
    integers.  An object array passes when every element is an integer (a
    column built from row tuples)."""
    a = np.asarray(keys)
    if a.dtype.kind == "O":
        try:
            a = np.asarray(a.tolist())
        except (OverflowError, ValueError):
            return None
        if a.size == 0:
            a = a.astype(np.int64)
    if a.dtype.kind not in "iu":
        return None
    return np.ascontiguousarray(a, np.int64)


def join_codes(lk, rk) -> Tuple[np.ndarray, np.ndarray]:
    """Both key columns as int64 the card can sort.  Integer keys pass as
    they are; other keys are factorized through an ``ObjectKeyIndex`` as
    JAX's ``device_join_pairs`` does: the left keys numbered in first-seen
    order, each right key its left code, or a distinct negative code when
    no left row has it (it joins with nothing)."""
    li, ri = _int_column(lk), _int_column(rk)
    if li is not None and ri is not None:
        return li, ri
    ki = ObjectKeyIndex()
    lcodes = ki.lookup_or_insert(np.asarray(lk, object)).astype(np.int64)
    rcodes = ki.lookup(np.asarray(rk, object)).astype(np.int64)
    return lcodes, np.where(rcodes < 0, -(np.arange(rcodes.size) + 2),
                            rcodes)


def spans(lk: torch.Tensor, rk: torch.Tensor):
    """The torch ops shared by :func:`pair_count` and :func:`pair_emit`:
    ``(ro, lo, counts)`` with ``ro`` the stable sort order of ``rk`` and
    ``[lo, lo + counts)`` each left row's span of it."""
    rks, ro = torch.sort(rk, stable=True)
    lo = torch.searchsorted(rks, lk, side="left")
    hi = torch.searchsorted(rks, lk, side="right")
    return ro, lo, hi - lo


def expand(ro, lo, counts, n, cap: int):
    """The pair expansion as torch ops (``_pair_emit``'s body):
    ``(left_idx[cap], right_idx[cap])`` int32, -1 past ``n``."""
    L, R = lo.shape[0], ro.shape[0]
    ends = torch.cumsum(counts, 0)
    off = ends - counts
    pos = torch.arange(cap, device=lo.device)
    li = torch.searchsorted(ends, pos, side="right").clamp_(max=L - 1)
    within = pos - off[li]
    ri = ro[(lo[li] + within).clamp_(max=R - 1)]
    valid = pos < n
    return (torch.where(valid, li, -1).to(torch.int32),
            torch.where(valid, ri, -1).to(torch.int32))


def plain_pair_spans(lk: np.ndarray, rk: np.ndarray):
    """Plain version of :func:`spans` (numpy)."""
    ro = np.argsort(rk, kind="stable")
    rks = rk[ro]
    lo = np.searchsorted(rks, lk, side="left")
    return ro, lo, np.searchsorted(rks, lk, side="right") - lo


def plain_pair_expand(ro, lo, counts, cap: int):
    """Plain version of :func:`expand`: each left row repeated over its
    span, the span's sorted right rows in order; pairs past ``cap`` drop."""
    n = int(counts.sum())
    li = np.repeat(np.arange(lo.size, dtype=np.int64), counts)
    within = np.arange(n, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts)
    m = min(n, cap)
    out_l = np.full(cap, -1, np.int32)
    out_r = np.full(cap, -1, np.int32)
    out_l[:m] = li[:m]
    out_r[:m] = ro[lo[li[:m]] + within[:m]]
    return out_l, out_r


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def pair_count(lk: torch.Tensor, rk: torch.Tensor) -> torch.Tensor:
    """Exact number of equi-join pairs of int64 key tensors (a 0-d int64
    tensor on their device): the sum of each left row's matching span."""
    if _on_cpu(lk):
        _, _, counts = plain_pair_spans(lk.numpy(), rk.numpy())
        return torch.tensor(int(counts.sum()))
    return spans(lk, rk)[2].sum()


def pair_emit(lk: torch.Tensor, rk: torch.Tensor, cap: int):
    """``(left_idx[cap], right_idx[cap], n)``: int32 pairs in left-major
    order, right matches in the right side's stable sort order, ``-1``
    past ``n`` (a 0-d int64 tensor).  ``cap`` below ``n`` truncates."""
    if _on_cpu(lk):
        ro, lo, counts = plain_pair_spans(lk.numpy(), rk.numpy())
        li, ri = plain_pair_expand(ro, lo, counts, cap)
        return (torch.from_numpy(li), torch.from_numpy(ri),
                torch.tensor(int(counts.sum())))
    ro, lo, counts = spans(lk, rk)
    n = counts.sum()
    li, ri = expand(ro, lo, counts, n, cap)
    return li, ri, n


#: what :func:`device_join_pairs` moved over the bus on a card, summed over
#: its calls since a caller last zeroed it (``h2d``: the two key columns;
#: ``d2h``: the count and the index pairs)
transfer_bytes = {"h2d": 0, "d2h": 0}


def device_join_pairs(lk, rk, device: DeviceLike = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Device sorted-merge equi-join with the contract of
    ``operators.joins._join_pairs``: int64 ``(left_idx, right_idx)`` of every
    cross pair with equal keys, left-major, each left row's matches in
    ascending right row.  Runs on ``device`` (``None``: the card, raising
    without one); keys that are not integers are factorized first
    (:func:`join_codes`)."""
    dev = resolve_device(device)
    if np.size(lk) == 0 or np.size(rk) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    lk, rk = join_codes(lk, rk)
    if dev.type == "cpu":
        ro, lo, counts = plain_pair_spans(lk, rk)
        n = int(counts.sum())
        if n == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        li, ri = plain_pair_expand(ro, lo, counts, n)
        return li.astype(np.int64), ri.astype(np.int64)
    tl = torch.from_numpy(lk).to(dev, non_blocking=False)
    tr = torch.from_numpy(rk).to(dev, non_blocking=False)
    ro, lo, counts = spans(tl, tr)
    n_t = counts.sum()
    n = int(n_t)                        # the one sync before the emit
    transfer_bytes["h2d"] += lk.nbytes + rk.nbytes
    transfer_bytes["d2h"] += n_t.element_size()
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    li, ri = expand(ro, lo, counts, n_t, quantize_pow2(n))
    pairs = torch.stack((li[:n], ri[:n])).cpu().numpy()
    transfer_bytes["d2h"] += pairs.nbytes
    return pairs[0].astype(np.int64), pairs[1].astype(np.int64)

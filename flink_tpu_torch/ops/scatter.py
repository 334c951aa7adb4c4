"""Scatter-combine: fold a record batch into dense keyed state (port of
``flink_tpu/ops/scatter.py`` ``scatter_fast``/``scatter_fold_counts``/
``combine_along_axis``), and the ordered replica fold.

JAX computes these as XLA scatters outside any Pallas kernel.  Here:

- :func:`scatter_fast` / :func:`scatter_fold_counts` are ``index_add_`` /
  ``scatter_reduce_``, updated **in place** (JAX returns new arrays; the
  caller donates the old ones).  JAX's ``mode="drop"`` discards ids ``>= N``
  (padding, probe misses); ``index_add_`` would raise on them, so a dropped
  row is rewritten to id 0 carrying its kind's identity (0 for add, +max for
  min, -max for max), which leaves every cell unchanged without a host sync.
  On the CPU the fold runs in row order like XLA's CPU scatter; on CUDA,
  ``index_add_`` on floats uses atomics in no fixed order, so sums into one
  cell may round differently from run to run.
- :func:`ordered_fold_counts` is the replica fold of the update step: on the
  CPU it is :func:`scatter_fold_counts`; on CUDA its ``add`` leaves and the
  counts fold through the hand-written kernel ``csrc/scatter_fold.cu``,
  which adds each cell's rows in row order, so the card's replica is
  bit-equal to the CPU's.  :func:`fold_plan` cuts the cells into the tiles
  of that kernel and of ``csrc/probe_fold.cu``, which share
  ``csrc/ordered_fold.cuh``.
- :func:`combine_along_axis` is the fire-time pane combine, plain torch ops
  in JAX's pairwise tree order.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# the ordered fold: tile plan, scratch, kernel wrapper
# ---------------------------------------------------------------------------

#: rows per block of the first and partition steps (``kBlockRows``)
FOLD_BLOCK_ROWS = 4096
#: most cell tiles a fold is cut into (``kMaxTiles``)
FOLD_MAX_TILES = 1024
#: fewest cells a tile holds, as a power of two
FOLD_MIN_TILE_BITS = 8
#: the four steps of ``csrc/scatter_fold.cu``, as bits of its ``steps`` mask
SCATTER_FOLD_STEPS = {"ids": 1, "scan": 2, "scatter": 4, "fold": 8}

#: value (= plane) dtypes of ``csrc/scatter_fold.cu``, with its kind codes
_SCATTER_FOLD_KINDS = {torch.float32: 0, torch.float64: 1, torch.int32: 2,
                       torch.int64: 3}


def fold_plan(n_rows: int, n_cells: int) -> Tuple[int, int, int]:
    """``(tile_bits, tiles, blocks)`` of one ordered fold launch: cells are
    cut into tiles of ``2^tile_bits`` (at least ``2^8``, and few enough that
    at most :data:`FOLD_MAX_TILES` tiles cover the planes; the last may be
    short), rows into blocks of :data:`FOLD_BLOCK_ROWS`.  More cells raise
    ``tile_bits``; no cell count below 2^31 is refused."""
    bits = max(FOLD_MIN_TILE_BITS, (max(n_cells, 1) - 1).bit_length()
               - (FOLD_MAX_TILES.bit_length() - 1))
    tiles = (n_cells + (1 << bits) - 1) >> bits
    blocks = (n_rows + FOLD_BLOCK_ROWS - 1) // FOLD_BLOCK_ROWS
    return bits, tiles, blocks


def fold_scratch(n_rows: int, n_cells: int, value_bytes: int,
                 device) -> Dict[str, torch.Tensor]:
    """The device scratch of one ordered fold launch: each row's cell id,
    the ``[blocks, tiles]`` count matrix (then its offsets), the tiles'
    bases (with the number of folding rows and a ticket of the offsets step
    after them), and the partitioned rows, ``(cell's low bits, value)`` in 8
    bytes for a 4-byte value and 16 for an 8-byte one."""
    bits, tiles, blocks = fold_plan(n_rows, n_cells)
    i32 = dict(dtype=torch.int32, device=device)
    return {"tile_bits": bits,
            "cell": torch.empty(n_rows, **i32),
            "counts": torch.empty(blocks * tiles, **i32),
            "tile_base": torch.empty(tiles + 2, **i32),
            "part": torch.empty((n_rows, 2 if value_bytes == 4 else 4),
                                **i32)}


def _check_ordered_fold_args(flat_leaves, flat_counts, slot_ids,
                             lifted_leaves, kinds) -> None:
    dev = slot_ids.device
    if slot_ids.dtype not in (torch.int32, torch.int64) \
            or slot_ids.ndim != 1 or not slot_ids.is_contiguous():
        raise ValueError("the ordered fold takes contiguous 1-D int32 or "
                         "int64 flat ids")
    if flat_counts.dtype != torch.int32 or flat_counts.ndim != 1 \
            or not flat_counts.is_contiguous():
        raise ValueError("the ordered fold takes flat contiguous int32 counts")
    n_cells = flat_counts.shape[0]
    if n_cells >= 2 ** 31 or slot_ids.shape[0] >= 2 ** 31:
        raise ValueError(f"the ordered fold takes fewer than 2^31 cells and "
                         f"rows, got {n_cells} and {slot_ids.shape[0]}")
    for leaf, lifted, kind in zip(flat_leaves, lifted_leaves, kinds):
        if kind not in SCATTER_KINDS:
            raise ValueError(f"unknown scatter kind {kind!r}")
        if leaf.device != dev or lifted.device != dev \
                or flat_counts.device != dev:
            raise ValueError(f"ordered fold tensors on {leaf.device}, "
                             f"{lifted.device} and {dev}")
        if kind == "add" and (leaf.shape != (n_cells,)
                              or lifted.shape != slot_ids.shape
                              or not leaf.is_contiguous()):
            raise ValueError("the ordered fold folds scalar add leaves: "
                             "flat contiguous [K*P] planes, one value a row")
        if kind == "add" and leaf.dtype not in _SCATTER_FOLD_KINDS:
            raise TypeError(f"the ordered fold folds f32, f64, i32 or i64 "
                            f"leaves, not {leaf.dtype}")


def launch_ordered_fold_steps(slot_ids, vals, plane, counts, scratch,
                              steps: int) -> None:
    """Launch the steps of ``csrc/scatter_fold.cu`` named by the ``steps``
    mask (:data:`SCATTER_FOLD_STEPS`) on the current stream: ``plane[f] += vals`` in
    row order for every id ``f`` in ``[0, len(plane))``, and ``counts[f] +=
    1`` unless ``counts`` is None.  ``vals`` must have ``plane``'s dtype.
    :func:`ordered_fold_counts` runs all four steps, a timing harness one at
    a time.  Counts no launch."""
    from flink_tpu_torch.kernels.build import scatter_fold_lib
    lib = scatter_fold_lib()
    stream = torch.cuda.current_stream(slot_ids.device).cuda_stream
    rc = lib.flink_scatter_fold_launch(
        slot_ids.data_ptr(), vals.data_ptr(), plane.data_ptr(),
        None if counts is None else counts.data_ptr(),
        scratch["cell"].data_ptr(), scratch["counts"].data_ptr(),
        scratch["tile_base"].data_ptr(), scratch["part"].data_ptr(),
        int(slot_ids.shape[0]), int(slot_ids.dtype == torch.int64),
        int(plane.shape[0]), int(scratch["tile_bits"]),
        _SCATTER_FOLD_KINDS[plane.dtype], int(steps), stream)
    if rc != 0:
        raise RuntimeError(f"scatter_fold kernel launch failed: cudaError "
                           f"{rc}")


def ordered_fold_counts(flat_leaves, flat_counts, slot_ids, lifted_leaves,
                        kinds: Sequence[str]):
    """One batch's fold into FLAT ``[K*P]`` keyed state, in place, that
    keeps row order in every cell: the value leaves combine by kind and the
    counts add one per kept row; ids outside ``[0, K*P)`` drop.

    CPU tensors take :func:`scatter_fold_counts` (the plain version: CPU
    ``index_add_`` is sequential, bit-equal to XLA's scatter).  CUDA tensors
    launch ``csrc/scatter_fold.cu`` once per ``add`` leaf, with the value
    cast to the leaf's dtype first and summed in it (``state[f] += v`` in
    row order), and the int32 counts folded by the first launch (with an
    integer atomic, whose sum is the same in any order); a tree with no
    ``add`` leaf folds the counts in one launch of ones.  ``min``/``max``
    leaves keep ``scatter_reduce_``: their value does not depend on the order
    of the rows, except which of -0.0 and +0.0 survives a tie and which NaN
    payload a NaN carries.  Anything else raises; nothing falls back.
    ``ordered_fold_counts.launches`` counts kernel launches."""
    if slot_ids.device.type == "cpu":
        return scatter_fold_counts(flat_leaves, flat_counts, slot_ids,
                                   lifted_leaves, kinds)
    if slot_ids.device.type != "cuda":
        raise ValueError(f"the ordered fold runs on cpu or cuda, not "
                         f"{slot_ids.device}")
    _check_ordered_fold_args(flat_leaves, flat_counts, slot_ids,
                             lifted_leaves, kinds)
    n, n_cells = int(slot_ids.shape[0]), int(flat_counts.shape[0])
    adds = [j for j, k in enumerate(kinds) if k == "add"]
    widest = max([flat_leaves[j].element_size() for j in adds] + [4])
    scratch = fold_scratch(n, n_cells, widest, slot_ids.device)
    counts = flat_counts
    for j in adds:
        vals = lifted_leaves[j].to(flat_leaves[j].dtype).contiguous()
        launch_ordered_fold_steps(slot_ids, vals, flat_leaves[j], counts,
                                  scratch, sum(SCATTER_FOLD_STEPS.values()))
        ordered_fold_counts.launches += 1
        counts = None
    if counts is not None:
        ones = torch.ones(n, dtype=torch.int32, device=slot_ids.device)
        launch_ordered_fold_steps(slot_ids, ones, counts, None, scratch,
                                  sum(SCATTER_FOLD_STEPS.values()))
        ordered_fold_counts.launches += 1
    for j, kind in enumerate(kinds):
        if kind != "add":
            scatter_fast((flat_leaves[j],), slot_ids, (lifted_leaves[j],),
                         (kind,))
    return tuple(flat_leaves), flat_counts


#: kernel launches of :func:`ordered_fold_counts` (CPU calls do not count)
ordered_fold_counts.launches = 0


# ---------------------------------------------------------------------------
# the fire-time pane combine
# ---------------------------------------------------------------------------

def combine_along_axis(leaves, combine_leaves: Callable, axis: int,
                       keepdims: bool = False):
    """Tree-reduce leaves along ``axis`` with the aggregate's monoid — the
    fire-time pane combine.  JAX's order: combine the first half with the
    second half, an odd tail concatenated after the merged half, until one
    remains; a sliding window's combine is then bit-equal to JAX's."""
    cur = tuple(leaves)
    size = cur[0].shape[axis]
    while size > 1:
        half = size // 2
        a = tuple(l.narrow(axis, 0, half) for l in cur)
        b = tuple(l.narrow(axis, half, half) for l in cur)
        merged = tuple(combine_leaves(a, b))
        if size % 2:
            merged = tuple(torch.cat([m, l.narrow(axis, 2 * half, 1)], axis)
                           for m, l in zip(merged, cur))
            size = half + 1
        else:
            size = half
        cur = merged
    if keepdims:
        return cur
    return tuple(l.squeeze(axis) for l in cur)

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
- :func:`ordered_fold_counts` is the ordered fold of the update step and of
  the probe lanes, and :func:`ordered_fold_counts_multi` folds several
  trees over one set of ids (the probe lane's replica and delta ring): on
  the CPU they are :func:`scatter_fold_counts` (and a loop of it, in
  :func:`scatter_fold_counts_multi`); on CUDA their ``add`` leaves and the
  counts fold through the hand-written kernel ``csrc/scatter_fold.cu``,
  which partitions the rows once for every plane and adds each cell's rows
  in row order, so the card's planes are bit-equal to the CPU's.
  :func:`ordered_fold` is the same kernel with one plane and no counts
  (the graph library's sum combine).
  :func:`scatter_plan` cuts its cells into tiles sized to the rows;
  :func:`fold_plan` cuts them into the tiles of ``csrc/probe_fold.cu``
  (with ``csrc/ordered_fold.cuh``).
- :func:`combine_along_axis` is the fire-time pane combine, plain torch ops
  in JAX's pairwise tree order.
- :func:`segment_running_fold`, :func:`segment_fold` and
  :func:`scatter_generic` are the generic fold of aggregates with no scatter
  kinds (an arbitrary ``combine``, such as ``LambdaReduce``'s): a stable
  sort by slot id, a segmented inclusive scan, and one write per segment
  end.  The combine is user code, a Python function on tensors, so there is
  no hand-written kernel here: the scan is :func:`_associative_scan`, a
  copy of JAX's ``lax.associative_scan`` recursion in torch ops (about
  ``log2(B)`` levels of the combine), whose grouping of each segment's
  combines, and so its float bits, is JAX's.
- :func:`gather_row_pane_columns`, :func:`reset_rows` and
  :func:`set_row_pane_columns` are the paging tier's page-out gather and
  page-in set, plain indexing into unique rows (deterministic), in place.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
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


#: float dtype -> the integer dtype of its total-order keys
TOTAL_ORDER_KEYS = {torch.float32: torch.int32, torch.float64: torch.int64}


def total_order(x: torch.Tensor) -> torch.Tensor:
    """f32/f64 values -> int32/int64 keys in IEEE total order (-0.0 below
    +0.0, as XLA's scatter min/max order them), and keys -> the values'
    bits (view them back as the float): the map is its own inverse.  A
    min/max over the keys picks a zero's sign by value, not by row order."""
    b = x.contiguous()
    if b.dtype.is_floating_point:
        b = b.view(TOTAL_ORDER_KEYS[b.dtype])
    return b ^ ((b >> (b.element_size() * 8 - 1)) & torch.iinfo(b.dtype).max)


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
# the ordered folds: tile plans, scratch, kernel wrapper
# ---------------------------------------------------------------------------

#: rows per block of ``csrc/probe_fold.cu``'s first and partition steps
#: (``kBlockRows`` of ``csrc/ordered_fold.cuh``)
FOLD_BLOCK_ROWS = 4096
#: most cell tiles a ``probe_fold`` is cut into (``kMaxTiles``)
FOLD_MAX_TILES = 1024
#: fewest cells a ``probe_fold`` tile holds, as a power of two
FOLD_MIN_TILE_BITS = 8

#: rows per block of ``csrc/scatter_fold.cu``'s partition step (``kPartRows``)
SCATTER_PART_ROWS = 2048
#: rows a ``scatter_fold`` fold block sorts at once (``kChunk``); the plan
#: sizes a tile to hold about half of it
SCATTER_CHUNK = 4096
#: most cell tiles a ``scatter_fold`` is cut into (``kMaxTiles``)
SCATTER_MAX_TILES = 1024
#: fewest tiles :func:`scatter_plan` aims for, so that a small batch still
#: spreads its fold over the card's SMs
SCATTER_MIN_TILES = 128
#: most value sources, planes and count planes one ``scatter_fold`` launch
#: takes (``kMaxSources``, ``kMaxPlanes``, ``kMaxCounts``)
SCATTER_MAX_OPERANDS = 8
#: the two steps of ``csrc/scatter_fold.cu``, as bits of its ``steps`` mask
SCATTER_FOLD_STEPS = {"partition": 1, "fold": 2}

#: value (= plane) dtypes of ``csrc/scatter_fold.cu``, with its kind codes
_SCATTER_FOLD_KINDS = {torch.float32: 0, torch.float64: 1, torch.int32: 2,
                       torch.int64: 3}
#: (plane, source) dtypes the kernel widens itself (exactly, as ``.to``)
_SCATTER_FOLD_WIDEN = {(torch.float64, torch.float32),
                       (torch.int64, torch.int32)}


def fold_plan(n_rows: int, n_cells: int) -> Tuple[int, int, int]:
    """``(tile_bits, tiles, blocks)`` of one ``probe_fold`` launch
    (``csrc/probe_fold.cu`` with ``csrc/ordered_fold.cuh``): cells are cut
    into tiles of ``2^tile_bits`` (at least ``2^8``, and few enough that at
    most :data:`FOLD_MAX_TILES` tiles cover the planes; the last may be
    short), rows into blocks of :data:`FOLD_BLOCK_ROWS`.  More cells raise
    ``tile_bits``; no cell count below 2^31 is refused."""
    bits = max(FOLD_MIN_TILE_BITS, (max(n_cells, 1) - 1).bit_length()
               - (FOLD_MAX_TILES.bit_length() - 1))
    tiles = (n_cells + (1 << bits) - 1) >> bits
    blocks = (n_rows + FOLD_BLOCK_ROWS - 1) // FOLD_BLOCK_ROWS
    return bits, tiles, blocks


def fold_scratch(n_rows: int, n_cells: int, value_bytes: int,
                 device) -> Dict[str, torch.Tensor]:
    """The device scratch of one ``probe_fold`` launch: each row's cell id,
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


def scatter_plan(n_rows: int, n_cells: int) -> Tuple[int, int, int]:
    """``(tile_bits, tiles, blocks)`` of one ``scatter_fold`` launch, sized
    to the rows: about one tile per ``SCATTER_CHUNK / 2`` rows (at least
    :data:`SCATTER_MIN_TILES`, at most :data:`SCATTER_MAX_TILES`), each of
    ``2^tile_bits`` cells (at least 2; the last may be short), so a uniform
    batch gives each fold block one chunk about half full of real rows (at
    the main path's 2^18 rows into 2^24 cells: 128 tiles of 2^17 cells).
    Rows are cut into blocks of :data:`SCATTER_PART_ROWS`.  No cell count
    below 2^31 is refused."""
    want = min(SCATTER_MAX_TILES,
               max(SCATTER_MIN_TILES, -(-n_rows // (SCATTER_CHUNK // 2))))
    per_tile = -(-max(n_cells, 1) // want)
    bits = max(1, (per_tile - 1).bit_length())
    tiles = (n_cells + (1 << bits) - 1) >> bits
    blocks = -(-n_rows // SCATTER_PART_ROWS)
    return bits, tiles, blocks


#: ``scatter_fold`` scratch per (device, stream), grown to the largest call
_SCATTER_SCRATCH: Dict[tuple, Dict[str, torch.Tensor]] = {}
#: held from a launch's scratch lookup to the end of its enqueue: threads
#: that launch on one stream (a cluster's subtask lanes, all on the default
#: stream) must not interleave their partition and fold launches, or a
#: fold reads the partition another thread's call wrote into the shared
#: scratch (ctypes lets go of the GIL during the launch call)
_SCATTER_LAUNCH_LOCK = threading.Lock()


def scatter_fold_scratch(n_rows: int, n_sources: int,
                         device) -> Dict[str, torch.Tensor]:
    """The device scratch of ``csrc/scatter_fold.cu`` on the current stream,
    cached and reused: the partition's low bits (int32 ``[rows]``), its
    value slots (8 bytes a row for each source, ``[sources, rows]``) and the
    offset table (``[blocks, SCATTER_MAX_TILES + 1]``), ``rows`` a whole
    number of blocks.  A call reuses the scratch of the call before it on
    the same stream, which the stream orders after it; the cache is keyed by
    stream, so two streams never share it.  It grows (to a power of two of
    blocks) when a call needs more, and never allocates otherwise."""
    device = torch.device(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device, stream)
    blocks = max(1, -(-n_rows // SCATTER_PART_ROWS))
    cur = _SCATTER_SCRATCH.get(key)
    if cur is not None and cur["low"].shape[0] >= blocks * SCATTER_PART_ROWS \
            and cur["vals"].shape[0] >= n_sources:
        return cur
    cap = 1 << (blocks - 1).bit_length()
    if cur is not None:
        cap = max(cap, cur["low"].shape[0] // SCATTER_PART_ROWS)
        n_sources = max(n_sources, cur["vals"].shape[0])
    rows = cap * SCATTER_PART_ROWS
    cur = _SCATTER_SCRATCH[key] = {
        "low": torch.empty(rows, dtype=torch.int32, device=device),
        "vals": torch.empty((max(n_sources, 1), rows), dtype=torch.int64,
                            device=device),
        "offs": torch.empty(cap * (SCATTER_MAX_TILES + 1), dtype=torch.int32,
                            device=device)}
    return cur


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
    if n_cells >= 2 ** 31 or slot_ids.shape[0] >= 2 ** 31 - SCATTER_PART_ROWS:
        raise ValueError(f"the ordered fold takes fewer than 2^31 cells and "
                         f"2^31 - {SCATTER_PART_ROWS} rows, got {n_cells} "
                         f"and {slot_ids.shape[0]}")
    if flat_counts.device != dev:
        raise ValueError(f"ordered fold tensors on {flat_counts.device} and "
                         f"{dev}")
    for leaf, lifted, kind in zip(flat_leaves, lifted_leaves, kinds):
        if kind not in SCATTER_KINDS:
            raise ValueError(f"unknown scatter kind {kind!r}")
        if leaf.device != dev or lifted.device != dev:
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


def _fold_source(leaf, lifted):
    """The value column a plane folds: ``lifted`` as it is where the plane
    has its dtype or the kernel widens it exactly, else cast first (the
    plain version's cast)."""
    if lifted.dtype != leaf.dtype \
            and (leaf.dtype, lifted.dtype) not in _SCATTER_FOLD_WIDEN:
        lifted = lifted.to(leaf.dtype)
    return lifted.contiguous()


def _fold_launches(groups, kinds):
    """The ``add`` leaves and count planes of ``groups`` packed into
    launches of at most :data:`SCATTER_MAX_OPERANDS` sources, planes and
    count planes each (one launch for any tree of up to eight ``add``
    leaves): a list of ``(sources, planes as (tensor, source index),
    counts)``.  Groups that fold the same lifted tensor share its
    source."""
    launches = [([], [], [])]

    def room(need_src: bool, planes: int, counts: int) -> bool:
        src, pl, cnt = launches[-1]
        return (len(src) + need_src <= SCATTER_MAX_OPERANDS
                and len(pl) + planes <= SCATTER_MAX_OPERANDS
                and len(cnt) + counts <= SCATTER_MAX_OPERANDS)

    for flat_leaves, flat_counts, lifted_leaves in groups:
        for leaf, lifted, kind in zip(flat_leaves, lifted_leaves, kinds):
            if kind != "add":
                continue
            vals = _fold_source(leaf, lifted)
            src = launches[-1][0]
            at = next((i for i, s in enumerate(src)
                       if s.data_ptr() == vals.data_ptr()
                       and s.dtype == vals.dtype), None)
            if not room(at is None, 1, 0):
                launches.append(([], [], []))
                src, at = launches[-1][0], None
            if at is None:
                src.append(vals)
                at = len(src) - 1
            launches[-1][1].append((leaf, at))
        if not room(False, 0, 1):
            launches.append(([], [], []))
        launches[-1][2].append(flat_counts)
    return launches


def launch_ordered_fold_steps(slot_ids, sources, planes, counts,
                              steps: int) -> None:
    """Launch the steps of ``csrc/scatter_fold.cu`` named by the ``steps``
    mask (:data:`SCATTER_FOLD_STEPS`: partition, then fold) on the current
    stream, for every id ``f`` in ``[0, n_cells)``: ``plane[f] +=
    sources[i][row]`` in row order for each ``(plane, i)`` of ``planes``,
    and ``c[f] += 1`` for each int32 plane ``c`` of ``counts``.  A plane
    has its source's dtype, or is f64 over f32 or i64 over i32 (widened
    exactly).  :func:`ordered_fold_counts` runs both steps, a timing
    harness one at a time (the scratch carries the partition from one to
    the other).  Counts no launch."""
    from flink_tpu_torch.kernels.build import scatter_fold_lib
    lib = scatter_fold_lib()
    n = int(slot_ids.shape[0])
    n_cells = int(counts[0].shape[0] if counts else planes[0][0].shape[0])
    bits, _, _ = scatter_plan(n, n_cells)
    with _SCATTER_LAUNCH_LOCK:
        _launch_steps(lib, slot_ids, sources, planes, counts, steps, n,
                      n_cells, bits)


def _launch_steps(lib, slot_ids, sources, planes, counts, steps: int, n: int,
                  n_cells: int, bits: int) -> None:
    """The enqueue of :func:`launch_ordered_fold_steps`, under
    :data:`_SCATTER_LAUNCH_LOCK`."""
    import ctypes

    scratch = scatter_fold_scratch(n, len(sources), slot_ids.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    src_ptrs = (vp * max(1, len(sources)))(*[s.data_ptr() for s in sources])
    src_kinds = (ci * max(1, len(sources)))(
        *[_SCATTER_FOLD_KINDS[s.dtype] for s in sources])
    dst_ptrs = (vp * max(1, len(planes)))(*[p.data_ptr() for p, _ in planes])
    dst_kinds = (ci * max(1, len(planes)))(
        *[_SCATTER_FOLD_KINDS[p.dtype] for p, _ in planes])
    dst_src = (ci * max(1, len(planes)))(*[i for _, i in planes])
    cnt_ptrs = (vp * max(1, len(counts)))(*[c.data_ptr() for c in counts])
    vals = scratch["vals"]
    stream = torch.cuda.current_stream(slot_ids.device).cuda_stream
    rc = lib.flink_scatter_fold_launch(
        slot_ids.data_ptr(), int(slot_ids.dtype == torch.int64), n, n_cells,
        bits, len(sources), ctypes.addressof(src_ptrs),
        ctypes.addressof(src_kinds), len(planes), ctypes.addressof(dst_ptrs),
        ctypes.addressof(dst_kinds), ctypes.addressof(dst_src), len(counts),
        ctypes.addressof(cnt_ptrs), scratch["low"].data_ptr(),
        vals.data_ptr(), vals.stride(0) * vals.element_size(),
        scratch["offs"].data_ptr(), int(steps), stream)
    if rc != 0:
        raise RuntimeError(f"scatter_fold kernel launch failed: cudaError "
                           f"{rc}")


def _ordered_fold(groups, slot_ids, kinds) -> int:
    """The card's side of :func:`ordered_fold_counts_multi`: check, launch
    ``csrc/scatter_fold.cu`` for the ``add`` leaves and the counts, fold
    ``min``/``max`` leaves with ``scatter_reduce_``; returns the number of
    launches (none for a batch with no rows or planes with no cells)."""
    if slot_ids.device.type != "cuda":
        raise ValueError(f"the ordered fold runs on cpu or cuda, not "
                         f"{slot_ids.device}")
    for flat_leaves, flat_counts, lifted_leaves in groups:
        _check_ordered_fold_args(flat_leaves, flat_counts, slot_ids,
                                 lifted_leaves, kinds)
    if len({int(g[1].shape[0]) for g in groups}) > 1:
        raise ValueError("the groups of one ordered fold fold into planes of "
                         "one length")
    launches = []
    if slot_ids.shape[0] and groups[0][1].shape[0]:   # rows and cells
        launches = _fold_launches(groups, kinds)
    for sources, planes, counts in launches:
        launch_ordered_fold_steps(slot_ids, sources, planes, counts,
                                  sum(SCATTER_FOLD_STEPS.values()))
    for flat_leaves, _, lifted_leaves in groups:
        for j, kind in enumerate(kinds):
            if kind != "add":
                scatter_fast((flat_leaves[j],), slot_ids,
                             (lifted_leaves[j],), (kind,))
    return len(launches)


def scatter_fold_counts_multi(groups, slot_ids, kinds: Sequence[str]):
    """Plain version of :func:`ordered_fold_counts_multi`: one
    :func:`scatter_fold_counts` per group, in order."""
    return [scatter_fold_counts(flat_leaves, flat_counts, slot_ids,
                                lifted_leaves, kinds)
            for flat_leaves, flat_counts, lifted_leaves in groups]


def ordered_fold_counts_multi(groups, slot_ids, kinds: Sequence[str]):
    """Several folds over one set of flat ids, in place, each keeping row
    order in every cell: ``groups`` is a sequence of ``(flat_leaves,
    flat_counts, lifted_leaves)``, each folded as :func:`ordered_fold_counts`
    folds it, all with ``kinds``.  The probe lane's update step folds its
    f32 replica and its f64 delta ring (and both count planes) this way.

    CPU tensors take :func:`scatter_fold_counts_multi`.  CUDA tensors launch
    ``csrc/scatter_fold.cu`` once for every ``add`` leaf and count plane of
    every group (the rows are partitioned once; up to
    :data:`SCATTER_MAX_OPERANDS` of each a launch), or raise.  Returns a list
    of ``(leaves, counts)``, one per group.
    ``ordered_fold_counts_multi.launches`` counts its kernel launches."""
    if slot_ids.device.type == "cpu":
        return scatter_fold_counts_multi(groups, slot_ids, kinds)
    ordered_fold_counts_multi.launches += _ordered_fold(groups, slot_ids,
                                                        kinds)
    return [(tuple(flat_leaves), flat_counts)
            for flat_leaves, flat_counts, _ in groups]


#: kernel launches of :func:`ordered_fold_counts_multi` (CPU calls do not
#: count)
ordered_fold_counts_multi.launches = 0


def ordered_fold_counts(flat_leaves, flat_counts, slot_ids, lifted_leaves,
                        kinds: Sequence[str]):
    """One batch's fold into FLAT ``[K*P]`` keyed state, in place, that
    keeps row order in every cell: the value leaves combine by kind and the
    counts add one per kept row; ids outside ``[0, K*P)`` drop.

    CPU tensors take :func:`scatter_fold_counts` (the plain version: CPU
    ``index_add_`` is sequential, bit-equal to XLA's scatter).  CUDA tensors
    launch ``csrc/scatter_fold.cu`` once for the whole tree: every ``add``
    leaf summed in its own dtype (``state[f] += v`` in row order, the value
    cast to the leaf's dtype first) and the int32 counts (an integer
    atomic, the same sum in any order); a tree with no ``add`` leaf folds
    only the counts.  ``min``/``max`` leaves keep ``scatter_reduce_``: their
    value does not depend on the order of the rows, except which of -0.0
    and +0.0 survives a tie and which NaN payload a NaN carries.  Anything
    else raises; nothing falls back.  ``ordered_fold_counts.launches``
    counts kernel launches."""
    if slot_ids.device.type == "cpu":
        return scatter_fold_counts(flat_leaves, flat_counts, slot_ids,
                                   lifted_leaves, kinds)
    ordered_fold_counts.launches += _ordered_fold(
        ((flat_leaves, flat_counts, lifted_leaves),), slot_ids, kinds)
    return tuple(flat_leaves), flat_counts


#: kernel launches of :func:`ordered_fold_counts` (CPU calls do not count)
ordered_fold_counts.launches = 0


def ordered_fold(plane, slot_ids, values):
    """``plane[f] += values[i]`` for every row ``i`` with ``f = slot_ids[i]``
    in ``[0, len(plane))``, in place and in row order in every cell, with
    no count plane: the graph library's sum combine (one superstep's
    messages into its vertices).  ``plane`` is flat and contiguous,
    ``values`` one value a row (cast to the plane's dtype first, or widened
    exactly by the kernel); ids outside the plane drop.

    CPU tensors take the plain version, ``index_add_`` (sequential, as
    XLA's CPU scatter).  CUDA tensors launch ``csrc/scatter_fold.cu`` once
    with one source, one plane and no count plane (none for no rows), or
    raise; nothing falls back.  ``ordered_fold.launches`` counts launches.
    """
    if slot_ids.device.type == "cpu":
        scatter_fast((plane,), slot_ids, (values,), ("add",))
        return plane
    if slot_ids.device.type != "cuda":
        raise ValueError(f"the ordered fold runs on cpu or cuda, not "
                         f"{slot_ids.device}")
    if plane.dtype not in _SCATTER_FOLD_KINDS or plane.ndim != 1 \
            or not plane.is_contiguous():
        raise TypeError(f"the ordered fold folds into a flat contiguous f32, "
                        f"f64, i32 or i64 plane, not {plane.dtype} "
                        f"{tuple(plane.shape)}")
    if slot_ids.dtype not in (torch.int32, torch.int64) \
            or slot_ids.ndim != 1 or not slot_ids.is_contiguous():
        raise ValueError("the ordered fold takes contiguous 1-D int32 or "
                         "int64 flat ids")
    if values.shape != slot_ids.shape:
        raise ValueError(f"{tuple(values.shape)} values for "
                         f"{tuple(slot_ids.shape)} ids")
    if plane.device != slot_ids.device or values.device != slot_ids.device:
        raise ValueError(f"ordered fold tensors on {plane.device}, "
                         f"{values.device} and {slot_ids.device}")
    if plane.shape[0] >= 2 ** 31 \
            or slot_ids.shape[0] >= 2 ** 31 - SCATTER_PART_ROWS:
        raise ValueError(f"the ordered fold takes fewer than 2^31 cells and "
                         f"2^31 - {SCATTER_PART_ROWS} rows, got "
                         f"{plane.shape[0]} and {slot_ids.shape[0]}")
    if slot_ids.shape[0] and plane.shape[0]:
        launch_ordered_fold_steps(slot_ids, [_fold_source(plane, values)],
                                  [(plane, 0)], [],
                                  sum(SCATTER_FOLD_STEPS.values()))
        ordered_fold.launches += 1
    return plane


#: kernel launches of :func:`ordered_fold` (CPU calls do not count)
ordered_fold.launches = 0


# ---------------------------------------------------------------------------
# row x pane sub-grids of [K, P] state: the paging tier's page-out and
# page-in (JAX computes these as XLA gathers and sets outside any kernel)
# ---------------------------------------------------------------------------

def gather_row_pane_columns(state_leaves, counts, rows, pane_slots):
    """Page-out gather: the ``rows x pane_slots`` sub-grid of ``[K, P, ...]``
    keyed state — ``(counts[V, m], leaves[V, m, *leaf])``.  Every id must be
    in range: JAX pads with ids that ``jnp.take`` clips, the callers here
    pass exactly the rows and panes they mean."""
    sel_counts = counts.index_select(0, rows).index_select(1, pane_slots)
    sel_leaves = tuple(l.index_select(0, rows).index_select(1, pane_slots)
                       for l in state_leaves)
    return sel_counts, sel_leaves


def reset_rows(state_leaves, counts, rows, leaf_inits) -> None:
    """Reset whole key rows (every pane slot) to the accumulator identity,
    in place.  ``rows`` are unique and in range (JAX pads with K and drops
    it; ``index_put_`` would raise on such an id)."""
    for l, init in zip(state_leaves, leaf_inits):
        l.index_fill_(0, rows, np.asarray(init).item())
    counts.index_fill_(0, rows, 0)


def set_row_pane_columns(state_leaves, counts, rows, pane_slots,
                         leaf_cols, counts_cols, leaf_inits) -> None:
    """Page-in, in place: reset the target rows across the whole ring, then
    set their ``pane_slots`` columns from the promoted cells
    (``counts_cols [R, m]``, one ``[R, m, *leaf]`` per leaf; identity where
    nothing was spilled).  Rows and panes unique and in range, as in
    :func:`reset_rows`."""
    reset_rows(state_leaves, counts, rows, leaf_inits)
    at = (rows.unsqueeze(1), pane_slots.unsqueeze(0))
    for l, col in zip(state_leaves, leaf_cols):
        l.index_put_(at, col.to(l.dtype))
    counts.index_put_(at, counts_cols.to(counts.dtype))


# ---------------------------------------------------------------------------
# the generic fold: a segmented associative scan in JAX's grouping
# ---------------------------------------------------------------------------

def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a[0], b[0], a[1], b[1], ...`` along axis 0 (``len(a)`` is
    ``len(b)`` or one more), as JAX's ``_interleave`` builds it: both padded
    with zeros into the other's positions and ADDED (OR for bool), so a
    ``-0.0`` comes out as ``+0.0`` there too."""
    shape = (a.shape[0] + b.shape[0],) + tuple(a.shape[1:])
    ap = torch.zeros(shape, dtype=a.dtype, device=a.device)
    bp = torch.zeros(shape, dtype=b.dtype, device=b.device)
    ap[0::2] = a
    bp[1::2] = b
    return ap | bp if a.dtype == torch.bool else ap + bp


def _associative_scan(fn: Callable, elems) -> list:
    """Inclusive scan of the list of ``[n, ...]`` tensors ``elems`` along
    axis 0 with the associative ``fn(a_list, b_list) -> list`` — the
    odd/even recursion of ``jax.lax.associative_scan`` (jax 0.9): combine
    the pairs ``(0,1), (2,3), ...``, scan those recursively (the odd
    outputs), combine each odd output with the next even input (the even
    outputs), put ``elems[0]`` first and interleave."""
    elems = list(elems)
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn([e[0:n - 1:2] for e in elems], [e[1::2] for e in elems])
    odd = _associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn([e[:-1] for e in odd], [e[2::2] for e in elems])
    else:
        even = fn(odd, [e[2::2] for e in elems])
    even = [torch.cat([e[:1], r]) for e, r in zip(elems, even)]
    return [_interleave(a, b) for a, b in zip(even, odd)]


def segment_running_fold(slot_ids, lifted_leaves, combine_leaves: Callable):
    """Per-record *running* segment fold (keyed ``reduce()`` semantics:
    every input record emits its key's fold-so-far within the batch).

    Returns ``(order[B], sids[B], is_end[B], prefix_leaves[B, ...])``:
    ``order`` maps sorted position -> original row (a stable sort, as
    ``jnp.argsort``), ``prefix_leaves[i]`` is the inclusive fold of the
    sorted rows of ``sids[i]``'s slot up to ``i``, and ``is_end`` flags the
    last row of each slot."""
    order = torch.argsort(slot_ids, stable=True)
    sids = slot_ids[order]
    svals = [l[order] for l in lifted_leaves]
    one = torch.ones((1,), dtype=torch.bool, device=sids.device)
    change = sids[1:] != sids[:-1]
    first = torch.cat([one, change])

    def seg_op(a, b):
        fa, va = a[0], a[1:]
        fb, vb = b[0], b[1:]
        merged = combine_leaves(tuple(va), tuple(vb))
        vals = [torch.where(_bcast(fb, m), y, m)
                for m, y in zip(merged, vb)]
        return [fa | fb] + vals

    scanned = _associative_scan(seg_op, [first] + svals)
    is_end = torch.cat([change, one])
    return order, sids, is_end, tuple(scanned[1:])


def segment_fold(slot_ids, lifted_leaves, combine_leaves: Callable,
                 num_slots: int = 0):
    """Generic per-batch segment reduction: ``(sids[B], is_end[B],
    folded_leaves[B, ...])``, where the rows flagged as segment ends hold
    the whole fold of their slot's records in this batch."""
    _, sids, is_end, folded = segment_running_fold(slot_ids, lifted_leaves,
                                                   combine_leaves)
    return sids, is_end, folded


def scatter_generic(state_leaves, slot_ids, lifted_leaves,
                    combine_leaves: Callable, num_slots: int):
    """Fold a batch into ``[num_slots, ...]`` state with an arbitrary
    monoid, in place: segment-fold the batch per slot, gather the current
    state at each segment's slot (clamped into range, as JAX's gather
    clamps), combine ``(current, folded)`` and write each segment end, cast
    to the state dtype.  Non-ends and ids outside ``[0, num_slots)`` are not
    written (JAX's ``mode="drop"``); the written ids are unique, so the
    write is race-free and deterministic on the card.  Plain torch ops on
    either device (the combine is user code)."""
    sids, is_end, folded = segment_fold(slot_ids, lifted_leaves,
                                        combine_leaves, num_slots)
    safe = torch.clamp(sids, max=num_slots - 1).to(torch.int64)
    current = tuple(l[safe] for l in state_leaves)
    merged = combine_leaves(current, folded)
    keep = is_end & (sids >= 0) & (sids < num_slots)
    idx = safe[keep]
    for l, m in zip(state_leaves, merged):
        l[idx] = m[keep].to(l.dtype)
    return tuple(state_leaves)


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

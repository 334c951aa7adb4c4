"""Device-resident key index: probe warm keys on the card (port of
``flink_tpu/state/device_keyindex.py``).

- An **open-addressing int64 -> int32 hash table as three int32 device
  planes** (``tab_lo``, ``tab_hi``, ``tab_slot1``; a zero ``slot1`` is an
  empty bucket).  The planes, bucket placement and slot ids are the JAX
  package's, plane for plane.  Bucket starts come from the same splitmix64
  ``_mix64`` as :mod:`flink_tpu_torch.state.keyindex`, computed on the host in
  one streaming pass.
- :func:`torch_probe` — the plain PyTorch version of the probe (the
  counterpart of ``lax_probe``); the CPU path and the reference the kernel is
  held to.
- :func:`probe` — the wrapper: on CPU tensors it runs :func:`torch_probe`; on
  CUDA tensors it launches the hand-written kernel ``csrc/probe.cu`` or
  raises.  ``probe.launches`` counts kernel launches.
- :func:`torch_probe_fold` / :func:`probe_fold` — the same pair for the fused
  probe + ordered delta fold (kernel ``csrc/probe_fold.cu``), gated by
  :func:`probe_fold_available`; ``probe_fold.launches`` counts launches.
- :class:`DeviceKeyIndex` — the host-side owner: a numpy occupancy shadow
  decides insert buckets (only our own scatters write the table, so shadow
  and table cannot diverge); ``ensure_loaded`` inserts whatever tail of the
  KeyIndex the table lacks; capacity is a sticky pow2 high-water.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from flink_tpu_torch import DeviceLike, resolve_device
from flink_tpu_torch.ops.scatter import scatter_fold_counts
from flink_tpu_torch.state.keyindex import _mix64, unique_first

#: probe miss marker in the slot output
MISS = -1


# ---------------------------------------------------------------------------
# host-side helpers: key split + bucket starts (streaming, no random access)
# ---------------------------------------------------------------------------

def split_keys(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """int64 keys -> (lo, hi) int32 word planes."""
    u = np.ascontiguousarray(keys, np.int64).view(np.uint64)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi = (u >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return lo, hi


def probe_starts(keys: np.ndarray, capacity: int) -> np.ndarray:
    """Bucket start per key: ``_mix64(key) & (capacity - 1)`` as int32."""
    h = _mix64(np.ascontiguousarray(keys, np.int64).view(np.uint64))
    return (h & np.uint64(capacity - 1)).astype(np.int64).astype(np.int32)


# ---------------------------------------------------------------------------
# the probe: plain version, kernel wrapper
# ---------------------------------------------------------------------------

def torch_probe(tab_lo, tab_hi, tab_slot1, key_lo, key_hi, start):
    """Vectorized open-addressing probe: int32 slots, -1 = miss.

    Each round gathers every still-pending record's bucket; hits resolve to
    ``slot1 - 1``, empty buckets to a miss, buckets held by another key step
    on.  Bounded at ``cap`` rounds like the kernel."""
    cap = tab_slot1.shape[0]
    slot = torch.full_like(start, MISS)
    pending = torch.arange(start.shape[0], device=start.device)
    idx = start.to(torch.int64)
    for _ in range(cap):
        if pending.numel() == 0:
            break
        b_s = tab_slot1.index_select(0, idx)
        empty = b_s == 0
        hit = ((~empty)
               & (tab_lo.index_select(0, idx) == key_lo.index_select(0, pending))
               & (tab_hi.index_select(0, idx) == key_hi.index_select(0, pending)))
        h = torch.nonzero(hit).squeeze(1)
        slot.index_copy_(0, pending.index_select(0, h), b_s.index_select(0, h) - 1)
        go_on = torch.nonzero(~(hit | empty)).squeeze(1)
        pending = pending.index_select(0, go_on)
        idx = (idx.index_select(0, go_on) + 1) & (cap - 1)
    return slot


def _check_probe_args(tab_lo, tab_hi, tab_slot1, key_lo, key_hi, start):
    args = (tab_lo, tab_hi, tab_slot1, key_lo, key_hi, start)
    dev = start.device
    for a in args:
        if a.dtype != torch.int32:
            raise TypeError(f"probe takes int32 planes, got {a.dtype}")
        if a.ndim != 1 or not a.is_contiguous():
            raise ValueError("probe takes contiguous 1-D planes")
        if a.device != dev:
            raise ValueError(f"probe planes on {a.device} and {dev}")
    cap = tab_slot1.shape[0]
    if cap <= 0 or cap & (cap - 1) or tab_lo.shape[0] != cap \
            or tab_hi.shape[0] != cap:
        raise ValueError("table planes must share one power-of-two length")
    if key_lo.shape[0] != start.shape[0] or key_hi.shape[0] != start.shape[0]:
        raise ValueError("key planes and starts must have one length")
    if start.shape[0] >= 2 ** 31 or cap >= 2 ** 31:
        raise ValueError("probe sizes must fit int32")


def probe(tab_lo, tab_hi, tab_slot1, key_lo, key_hi, start):
    """Probe ``(key_lo, key_hi)`` from ``start`` in the table planes: int32
    slots, -1 = miss.  CPU tensors take :func:`torch_probe`; CUDA tensors
    launch ``csrc/probe.cu`` on the current stream or raise."""
    _check_probe_args(tab_lo, tab_hi, tab_slot1, key_lo, key_hi, start)
    if start.device.type == "cpu":
        return torch_probe(tab_lo, tab_hi, tab_slot1, key_lo, key_hi, start)
    if start.device.type != "cuda":
        raise ValueError(f"probe runs on cpu or cuda, not {start.device}")
    from flink_tpu_torch.kernels.build import probe_lib
    lib = probe_lib()
    out = torch.empty_like(start)
    stream = torch.cuda.current_stream(start.device).cuda_stream
    rc = lib.flink_probe_launch(
        tab_lo.data_ptr(), tab_hi.data_ptr(), tab_slot1.data_ptr(),
        key_lo.data_ptr(), key_hi.data_ptr(), start.data_ptr(),
        out.data_ptr(), int(start.shape[0]), int(tab_slot1.shape[0]), stream)
    if rc != 0:
        raise RuntimeError(f"probe kernel launch failed: cudaError {rc}")
    probe.launches += 1
    return out


#: kernel launches of :func:`probe` (CPU calls do not count)
probe.launches = 0


# ---------------------------------------------------------------------------
# the fused probe + ordered fold: gate, plain version, kernel wrapper
# ---------------------------------------------------------------------------

#: (value dtype, delta-plane dtype) pairs the fold kernel widens itself, with
#: the kind code of ``csrc/probe_fold.cu``'s fold entry; other value dtypes
#: are cast to the plane's dtype first
_FOLD_KINDS = {(torch.float32, torch.float64): 0,
               (torch.float64, torch.float64): 1,
               (torch.int32, torch.int64): 2,
               (torch.int64, torch.int64): 3}


def probe_fold_available(kinds, delta_dtype) -> bool:
    """True iff :func:`probe_fold` serves this accumulator: a single scalar
    ``add`` leaf (the gate of JAX's ``pallas_probe_fold_available``) whose
    delta plane is f64 (float leaves) or i64 (integer leaves).

    JAX's gate also fits the table plus the flat delta planes into 12 MiB of
    TPU VMEM, because the Pallas kernel pins both whole.  On the H100 the
    planes stay in HBM and the kernel reads them through L2, so there is no
    size budget: at the main path's full width (a 24 MiB table, a 192 MiB
    delta ring) the kernel is on the path, where the TPU gate would have kept
    the Pallas kernel off it."""
    return (kinds is not None and tuple(kinds) == ("add",)
            and delta_dtype in (torch.float64, torch.int64))


def torch_probe_fold(tab_lo, tab_hi, tab_slot1, key_lo, key_hi, start,
                     pane_slots, b: int, vals, dsum, dcnt, pane_mod: int):
    """Plain version of the fused probe + fold (the counterpart of JAX's
    ``lax_probe`` + ``scatter_fold_counts``): :func:`torch_probe`, then
    every hit row ``k < b`` whose cell ``slot * pane_mod + pane_slots[k]``
    lies in the planes folds into it, in row order: ``dsum += vals`` (cast
    to dsum's dtype), ``dcnt += 1``, in place.  Returns
    ``(slot, dsum, dcnt)``."""
    slot = torch_probe(tab_lo, tab_hi, tab_slot1, key_lo, key_hi, start)
    flat = slot.to(torch.int64) * pane_mod + pane_slots
    rows = torch.arange(slot.shape[0], device=slot.device)
    hit = torch.nonzero((rows < b) & (slot >= 0) & (flat >= 0)
                        & (flat < dsum.shape[0])).squeeze(1)
    scatter_fold_counts((dsum,), dcnt, flat.index_select(0, hit),
                        (vals.index_select(0, hit),), ("add",))
    return slot, dsum, dcnt


def _check_fold_args(start, pane_slots, b, vals, dsum, dcnt, pane_mod):
    dev = start.device
    if pane_slots.dtype != torch.int32 or pane_slots.shape != start.shape \
            or not pane_slots.is_contiguous():
        raise ValueError("pane_slots must be contiguous int32 like start")
    if vals.shape != start.shape or not vals.is_contiguous():
        raise ValueError("vals must be one contiguous value per row")
    if dsum.dtype not in (torch.float64, torch.int64):
        raise TypeError(f"probe_fold folds into f64 or i64 planes, not "
                        f"{dsum.dtype}")
    if dcnt.dtype != torch.int32 or dsum.ndim != 1 or dcnt.ndim != 1 \
            or dcnt.shape != dsum.shape or not dsum.is_contiguous() \
            or not dcnt.is_contiguous():
        raise ValueError("dsum and dcnt must be contiguous flat planes of one "
                         "length, dcnt int32")
    for a in (pane_slots, vals, dsum, dcnt):
        if a.device != dev:
            raise ValueError(f"probe_fold tensors on {a.device} and {dev}")
    if not 0 <= int(b) <= start.shape[0] or int(pane_mod) <= 0:
        raise ValueError(f"need 0 <= b <= rows and pane_mod > 0, got b={b} "
                         f"pane_mod={pane_mod}")


def probe_fold(tab_lo, tab_hi, tab_slot1, key_lo, key_hi, start, pane_slots,
               b: int, vals, dsum, dcnt, pane_mod: int):
    """Fused probe + ordered fold (JAX's ``pallas_probe_fold``): the probe of
    :func:`probe`, then every hit row ``k < b`` folds into the flat delta
    planes at ``slot * pane_mod + pane_slots[k]`` in row order, in place.
    Returns ``(slot, dsum, dcnt)``.  CPU tensors take
    :func:`torch_probe_fold`; CUDA tensors launch ``csrc/probe_fold.cu`` on
    the current stream (probe kernel, a stable sort of the cell ids, fold
    kernel) or raise.  ``probe_fold.launches`` counts launches."""
    _check_probe_args(tab_lo, tab_hi, tab_slot1, key_lo, key_hi, start)
    _check_fold_args(start, pane_slots, b, vals, dsum, dcnt, pane_mod)
    if start.device.type == "cpu":
        return torch_probe_fold(tab_lo, tab_hi, tab_slot1, key_lo, key_hi,
                                start, pane_slots, b, vals, dsum, dcnt,
                                pane_mod)
    if start.device.type != "cuda":
        raise ValueError(f"probe_fold runs on cpu or cuda, not {start.device}")
    from flink_tpu_torch.kernels.build import probe_fold_lib
    lib = probe_fold_lib()
    if (vals.dtype, dsum.dtype) not in _FOLD_KINDS:
        vals = vals.to(dsum.dtype)      # the plain fold's cast, done first
    n = int(start.shape[0])
    slot = torch.empty_like(start)
    flat = torch.empty(n, dtype=torch.int64, device=start.device)
    stream = torch.cuda.current_stream(start.device).cuda_stream
    rc = lib.flink_probe_fold_probe(
        tab_lo.data_ptr(), tab_hi.data_ptr(), tab_slot1.data_ptr(),
        key_lo.data_ptr(), key_hi.data_ptr(), start.data_ptr(),
        pane_slots.data_ptr(), slot.data_ptr(), flat.data_ptr(), n, int(b),
        int(tab_slot1.shape[0]), int(pane_mod), int(dsum.shape[0]), stream)
    if rc != 0:
        raise RuntimeError(f"probe_fold probe kernel launch failed: "
                           f"cudaError {rc}")
    sflat, perm = torch.sort(flat, stable=True)
    rc = lib.flink_probe_fold_fold(
        sflat.data_ptr(), perm.data_ptr(), vals.data_ptr(), dsum.data_ptr(),
        dcnt.data_ptr(), n, _FOLD_KINDS[(vals.dtype, dsum.dtype)], stream)
    if rc != 0:
        raise RuntimeError(f"probe_fold fold kernel launch failed: "
                           f"cudaError {rc}")
    probe_fold.launches += 1
    return slot, dsum, dcnt


#: launches of :func:`probe_fold` on the card (CPU calls do not count)
probe_fold.launches = 0


# ---------------------------------------------------------------------------
# DeviceKeyIndex — host-side owner of the device table
# ---------------------------------------------------------------------------

class DeviceKeyIndex:
    """Device twin of a :class:`~flink_tpu_torch.state.keyindex.KeyIndex`.

    The KeyIndex stays the slot-id authority; ``ensure_loaded`` places
    whatever tail of slots the table has not seen in the host occupancy
    shadow (the same linear probing the device walk runs) and ships them as
    one scatter per plane.  The device never inserts, so shadow and table
    cannot diverge.  Capacity is a sticky pow2 high-water: growth rebuilds
    shadow and table at the doubled size, never shrinks.
    """

    def __init__(self, initial_capacity: int = 1 << 16,
                 max_load: float = 0.5, device: DeviceLike = None):
        self.device = resolve_device(device)
        cap = 1 << 10
        while cap < initial_capacity:
            cap <<= 1
        self._max_load = max_load
        self._n = 0               # slots loaded into the table
        self._alloc(cap)

    def _alloc(self, cap: int) -> None:
        self.capacity = cap
        self._shadow_used = np.zeros(cap, bool)
        self.tab_lo = torch.zeros(cap, dtype=torch.int32, device=self.device)
        self.tab_hi = torch.zeros(cap, dtype=torch.int32, device=self.device)
        self.tab_slot1 = torch.zeros(cap, dtype=torch.int32,
                                     device=self.device)

    def _place(self, keys: np.ndarray) -> np.ndarray:
        """Claim one shadow bucket per (unique) key by linear probing;
        returns the bucket indices.  Same-bucket races resolve by
        first-in-batch, losers re-probe."""
        n = keys.size
        buckets = np.full(n, -1, np.int64)
        pidx = probe_starts(keys, self.capacity).astype(np.int64)
        pending = np.arange(n, dtype=np.int64)
        maskv = np.int64(self.capacity - 1)
        while pending.size:
            free = ~self._shadow_used[pidx]
            f_pend = pending[free]
            f_idx = pidx[free]
            if f_pend.size:
                win_idx, first = unique_first(f_idx)
                self._shadow_used[win_idx] = True
                buckets[f_pend[first]] = win_idx
            unresolved = buckets[pending] < 0
            pending = pending[unresolved]
            pidx = (pidx[unresolved] + 1) & maskv
        return buckets

    def table(self):
        return self.tab_lo, self.tab_hi, self.tab_slot1

    def prepare_batch(self, keys: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(key_lo, key_hi, start) int32 planes for one batch: the only
        per-record host work of the probe lane (streaming hash + split)."""
        lo, hi = split_keys(keys)
        return lo, hi, probe_starts(keys, self.capacity)

    def ensure_loaded(self, key_index) -> int:
        """Insert slots [num_loaded, num_keys) of ``key_index``: initial
        load, restore reload and per-batch miss inserts are this one path.
        Returns the number of newly inserted keys."""
        n = int(key_index.num_keys)
        if n == self._n:
            return 0
        if n < self._n:
            # the key index was reset/restored under us: rebuild from empty
            self._n = 0
            self._alloc(self.capacity)
        if n > int(self.capacity * self._max_load):
            self._grow(n)
        rev = np.asarray(key_index.reverse_keys(), np.int64)
        new_keys = rev[self._n:n]
        buckets = self._place(new_keys)
        slots1 = np.arange(self._n + 1, n + 1, dtype=np.int32)
        self._upload(buckets, new_keys, slots1)
        inserted = n - self._n
        self._n = n
        return inserted

    def _upload(self, buckets: np.ndarray, keys: np.ndarray,
                slots1: np.ndarray) -> None:
        """One scatter per plane (in place; JAX donated the planes)."""
        lo, hi = split_keys(keys)
        b = torch.from_numpy(np.ascontiguousarray(buckets, np.int64)).to(
            self.device)
        for plane, vals in ((self.tab_lo, lo), (self.tab_hi, hi),
                            (self.tab_slot1, slots1)):
            plane[b] = torch.from_numpy(np.ascontiguousarray(vals)).to(
                self.device)

    def _grow(self, needed: int) -> None:
        """Sticky pow2 growth: double until ``needed`` fits the load factor,
        re-place every loaded key (read back from the old planes), upload."""
        cap = self.capacity
        while needed > int(cap * self._max_load):
            cap <<= 1
        if cap == self.capacity:
            return
        loaded = self._n
        old_lo = self.tab_lo.cpu().numpy()
        old_hi = self.tab_hi.cpu().numpy()
        old_s1 = self.tab_slot1.cpu().numpy()
        occ = old_s1 > 0
        keys_u = (old_lo[occ].view(np.uint32).astype(np.uint64)
                  | (old_hi[occ].view(np.uint32).astype(np.uint64)
                     << np.uint64(32)))
        keys = keys_u.view(np.int64)
        slots1 = old_s1[occ]
        self._alloc(cap)
        self._n = loaded
        if keys.size:
            self._upload(self._place(keys), keys, slots1)

"""Device-resident key index: probe warm keys on the card (port of
``flink_tpu/state/device_keyindex.py``).

- An **open-addressing int64 -> int32 hash table as one interleaved bucket
  array**: ``buckets`` is a contiguous int32 ``[cap, 4]`` tensor whose rows
  are ``(lo, hi, slot1, 0)``; a zero ``slot1`` is an empty bucket.  A row
  is 16 bytes, so the kernels read a whole bucket with one load, and a
  32-byte sector holds two neighbouring buckets of a linear walk.  The
  JAX package keeps three planes; ``tab_lo``, ``tab_hi`` and ``tab_slot1``
  here are column views of ``buckets``, and bucket placement and slot ids
  are the JAX package's, plane for plane.
- **The probe hashes on the card.**  :func:`probe` and :func:`probe_fold`
  take the int64 keys; the bucket start is ``_mix64(key) & (cap - 1)``,
  the splitmix64 finalizer of :mod:`flink_tpu_torch.state.keyindex`, which
  the kernels compute in uint64 arithmetic and :func:`torch_mix64` on int64
  tensors.  The host hashes only keys it inserts (:meth:`DeviceKeyIndex._place`).
- :func:`torch_probe` — the plain PyTorch version of the probe (the
  counterpart of ``lax_probe``); the CPU path and the reference the kernel is
  held to.
- :func:`probe` — the wrapper: on CPU tensors it runs :func:`torch_probe`; on
  CUDA tensors it launches the hand-written kernel ``csrc/probe.cu`` or
  raises.  ``probe.launches`` counts kernel launches.
- :func:`torch_probe_fold` / :func:`probe_fold` — the same pair for the fused
  probe + ordered delta fold (kernels ``csrc/probe_fold.cu``), gated by
  :func:`probe_fold_available`; ``probe_fold.launches`` counts launches.
- :class:`DeviceKeyIndex` — the host-side owner: a numpy occupancy shadow
  decides insert buckets (only our own scatters write the table, so shadow
  and table cannot diverge); ``ensure_loaded`` inserts whatever tail of the
  KeyIndex the table lacks; capacity is a sticky pow2 high-water.
- :func:`calibrated_device_probe` — the ``device_probe="auto"`` verdict,
  measured once a process: the probe lane (the ``probe`` kernel and the
  ordered fold into an f64 delta plane) against the C host pass.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch import DeviceLike, resolve_device
from flink_tpu_torch.ops.scatter import (FOLD_BLOCK_ROWS,  # noqa: F401
                                         FOLD_MAX_TILES, FOLD_MIN_TILE_BITS,
                                         fold_plan, fold_scratch,
                                         scatter_fold_counts)
from flink_tpu_torch.state.keyindex import _mix64, unique_first

#: probe miss marker in the slot output
MISS = -1


# ---------------------------------------------------------------------------
# host-side helpers: key split + bucket starts, for key inserts and tests
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
# the hash on torch tensors
# ---------------------------------------------------------------------------

#: splitmix64's multipliers as the signed int64 values of their bits
_MIX_M1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX_M2 = 0x94D049BB133111EB - (1 << 64)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits: torch's ``>>`` sign-extends, so
    the high ``s`` bits are masked off."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def torch_mix64(x: torch.Tensor) -> torch.Tensor:
    """:func:`~flink_tpu_torch.state.keyindex._mix64` on an int64 tensor:
    the same bits, read as int64 (products wrap mod 2^64 as uint64's do)."""
    x = (x ^ _shr(x, 30)) * _MIX_M1
    x = (x ^ _shr(x, 27)) * _MIX_M2
    return x ^ _shr(x, 31)


def torch_probe_starts(keys: torch.Tensor, capacity: int) -> torch.Tensor:
    """Bucket start per int64 key, as int64: :func:`probe_starts` on the
    tensor's device."""
    return torch_mix64(keys) & (capacity - 1)


def bucket_keys(rows: torch.Tensor) -> torch.Tensor:
    """The int64 key of each ``[m, 4]`` bucket row: ``hi * 2^32 + lo`` with
    ``lo`` read unsigned (no product or sum leaves int64's range)."""
    return rows[:, 1].long() * (1 << 32) + (rows[:, 0].long() & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# the probe: plain version, kernel wrapper
# ---------------------------------------------------------------------------

def torch_probe(buckets, keys):
    """Vectorized open-addressing probe: int32 slots, -1 = miss.

    Each round gathers every still-pending key's bucket row; hits resolve
    to ``slot1 - 1``, empty buckets to a miss, buckets held by another key
    step on.  Bounded at ``cap`` rounds like the kernel."""
    cap = buckets.shape[0]
    slot = torch.full(keys.shape, MISS, dtype=torch.int32, device=keys.device)
    pending = torch.arange(keys.shape[0], device=keys.device)
    idx = torch_probe_starts(keys, cap)
    for _ in range(cap):
        if pending.numel() == 0:
            break
        rows = buckets.index_select(0, idx)
        b_s = rows[:, 2]
        empty = b_s == 0
        hit = (~empty) & (bucket_keys(rows) == keys.index_select(0, pending))
        h = torch.nonzero(hit).squeeze(1)
        slot.index_copy_(0, pending.index_select(0, h), b_s.index_select(0, h) - 1)
        go_on = torch.nonzero(~(hit | empty)).squeeze(1)
        pending = pending.index_select(0, go_on)
        idx = (idx.index_select(0, go_on) + 1) & (cap - 1)
    return slot


def _check_probe_args(buckets, keys):
    if buckets.dtype != torch.int32 or buckets.ndim != 2 \
            or buckets.shape[1] != 4 or not buckets.is_contiguous():
        raise TypeError("probe takes a contiguous int32 [cap, 4] bucket "
                        "array")
    if keys.dtype != torch.int64:
        raise TypeError(f"probe takes int64 keys, got {keys.dtype}")
    if keys.ndim != 1 or not keys.is_contiguous():
        raise ValueError("probe takes contiguous 1-D keys")
    if buckets.device != keys.device:
        raise ValueError(f"probe tensors on {buckets.device} and "
                         f"{keys.device}")
    cap = buckets.shape[0]
    if cap <= 0 or cap & (cap - 1):
        raise ValueError("the bucket array's length must be a power of two")
    if keys.shape[0] >= 2 ** 31 or cap >= 2 ** 31:
        raise ValueError("probe sizes must fit int32")
    if buckets.data_ptr() % 16:
        raise ValueError("the bucket array must be 16-byte aligned")


def _device_of(keys) -> str:
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the probe runs on cpu or cuda, not {keys.device}")
    return keys.device.type


def probe(buckets, keys):
    """Probe the int64 ``keys`` in the bucket array: int32 slots, -1 = miss.
    CPU tensors take :func:`torch_probe`; CUDA tensors launch
    ``csrc/probe.cu`` (which hashes the keys itself) on the current stream
    or raise."""
    _check_probe_args(buckets, keys)
    if _device_of(keys) == "cpu":
        return torch_probe(buckets, keys)
    from flink_tpu_torch.kernels.build import probe_lib
    lib = probe_lib()
    out = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    rc = lib.flink_probe_launch(buckets.data_ptr(), keys.data_ptr(),
                                out.data_ptr(), int(keys.shape[0]),
                                int(buckets.shape[0]), stream)
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
#: the kind code of ``csrc/probe_fold.cu``; other value dtypes are cast to
#: the plane's dtype first
_FOLD_KINDS = {(torch.float32, torch.float64): 0,
               (torch.float64, torch.float64): 1,
               (torch.int32, torch.int64): 2,
               (torch.int64, torch.int64): 3}

#: the four steps of ``csrc/probe_fold.cu``, as bits of its ``steps`` mask
FOLD_STEPS = {"probe": 1, "scan": 2, "scatter": 4, "fold": 8}


def probe_fold_available(kinds, delta_dtype) -> bool:
    """True iff :func:`probe_fold` serves this accumulator: a single scalar
    ``add`` leaf (the gate of JAX's ``pallas_probe_fold_available``) whose
    delta plane is f64 (float leaves) or i64 (integer leaves).

    JAX's gate also fits the table plus the flat delta planes into 12 MiB of
    TPU VMEM, because the Pallas kernel pins both whole.  On the H100 the
    planes stay in HBM and the kernel reads them through L2, so there is no
    size budget: at the main path's full width (a 32 MiB table, a 192 MiB
    delta ring) the kernel is on the path, where the TPU gate would have kept
    the Pallas kernel off it."""
    return (kinds is not None and tuple(kinds) == ("add",)
            and delta_dtype in (torch.float64, torch.int64))


def torch_probe_fold(buckets, keys, pane_slots, b: int, vals, dsum, dcnt,
                     pane_mod: int):
    """Plain version of the fused probe + fold (the counterpart of JAX's
    ``lax_probe`` + ``scatter_fold_counts``): :func:`torch_probe`, then
    every hit row ``k < b`` whose cell ``slot * pane_mod + pane_slots[k]``
    lies in the planes folds into it, in row order: ``dsum += vals`` (cast
    to dsum's dtype), ``dcnt += 1``, in place.  Returns
    ``(slot, dsum, dcnt)``."""
    slot = torch_probe(buckets, keys)
    flat = slot.to(torch.int64) * pane_mod + pane_slots
    rows = torch.arange(slot.shape[0], device=slot.device)
    hit = torch.nonzero((rows < b) & (slot >= 0) & (flat >= 0)
                        & (flat < dsum.shape[0])).squeeze(1)
    scatter_fold_counts((dsum,), dcnt, flat.index_select(0, hit),
                        (vals.index_select(0, hit),), ("add",))
    return slot, dsum, dcnt


def _check_fold_args(keys, pane_slots, b, vals, dsum, dcnt, pane_mod):
    dev = keys.device
    if pane_slots.dtype != torch.int32 or pane_slots.shape != keys.shape \
            or not pane_slots.is_contiguous():
        raise ValueError("pane_slots must be contiguous int32, one per key")
    if vals.shape != keys.shape or not vals.is_contiguous():
        raise ValueError("vals must be one contiguous value per row")
    if dsum.dtype not in (torch.float64, torch.int64):
        raise TypeError(f"probe_fold folds into f64 or i64 planes, not "
                        f"{dsum.dtype}")
    if dcnt.dtype != torch.int32 or dsum.ndim != 1 or dcnt.ndim != 1 \
            or dcnt.shape != dsum.shape or not dsum.is_contiguous() \
            or not dcnt.is_contiguous():
        raise ValueError("dsum and dcnt must be contiguous flat planes of one "
                         "length, dcnt int32")
    if dsum.shape[0] >= 2 ** 31:
        raise ValueError(f"probe_fold takes fewer than 2^31 cells, got "
                         f"{dsum.shape[0]}")
    for a in (pane_slots, vals, dsum, dcnt):
        if a.device != dev:
            raise ValueError(f"probe_fold tensors on {a.device} and {dev}")
    if not 0 <= int(b) <= keys.shape[0] or not 0 < int(pane_mod) < 2 ** 31:
        raise ValueError(f"need 0 <= b <= rows and 0 < pane_mod < 2^31, got "
                         f"b={b} pane_mod={pane_mod}")


def probe_fold_scratch(n_rows: int, n_cells: int,
                       vals: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The device scratch of one ``probe_fold`` launch
    (:func:`~flink_tpu_torch.ops.scatter.fold_scratch`; the plan and the
    steps 2-4 are those of ``csrc/ordered_fold.cuh``)."""
    return fold_scratch(n_rows, n_cells, vals.element_size(), vals.device)


def launch_probe_fold_steps(buckets, keys, pane_slots, b: int, vals, dsum,
                            dcnt, pane_mod: int, slot, scratch,
                            steps: int) -> None:
    """Launch the steps of ``csrc/probe_fold.cu`` named by the ``steps``
    mask (:data:`FOLD_STEPS`) on the current stream; :func:`probe_fold` runs
    all four, a timing harness one at a time.  ``vals`` must already be of
    a kind the kernel takes (:data:`_FOLD_KINDS`).  Counts no launch."""
    from flink_tpu_torch.kernels.build import probe_fold_lib
    lib = probe_fold_lib()
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    rc = lib.flink_probe_fold_launch(
        buckets.data_ptr(), keys.data_ptr(), pane_slots.data_ptr(),
        vals.data_ptr(), dsum.data_ptr(), dcnt.data_ptr(), slot.data_ptr(),
        scratch["cell"].data_ptr(), scratch["counts"].data_ptr(),
        scratch["tile_base"].data_ptr(), scratch["part"].data_ptr(),
        int(keys.shape[0]), int(b),
        int(buckets.shape[0]), int(pane_mod), int(dsum.shape[0]),
        int(scratch["tile_bits"]), _FOLD_KINDS[(vals.dtype, dsum.dtype)],
        int(steps), stream)
    if rc != 0:
        raise RuntimeError(f"probe_fold kernel launch failed: cudaError {rc}")


def probe_fold(buckets, keys, pane_slots, b: int, vals, dsum, dcnt,
               pane_mod: int):
    """Fused probe + ordered fold (JAX's ``pallas_probe_fold``): the probe of
    :func:`probe`, then every hit row ``k < b`` folds into the flat delta
    planes at ``slot * pane_mod + pane_slots[k]`` in row order, in place.
    Returns ``(slot, dsum, dcnt)``.  CPU tensors take
    :func:`torch_probe_fold`; CUDA tensors launch the four kernels of
    ``csrc/probe_fold.cu`` on the current stream (probe + tile histogram,
    offsets, stable partition by tile, ordered fold per tile) or raise.
    ``probe_fold.launches`` counts launches."""
    _check_probe_args(buckets, keys)
    _check_fold_args(keys, pane_slots, b, vals, dsum, dcnt, pane_mod)
    if _device_of(keys) == "cpu":
        return torch_probe_fold(buckets, keys, pane_slots, b, vals, dsum,
                                dcnt, pane_mod)
    if (vals.dtype, dsum.dtype) not in _FOLD_KINDS:
        vals = vals.to(dsum.dtype)      # the plain fold's cast, done first
    n = int(keys.shape[0])
    slot = torch.empty(n, dtype=torch.int32, device=keys.device)
    launch_probe_fold_steps(buckets, keys, pane_slots, b, vals, dsum, dcnt,
                            pane_mod, slot,
                            probe_fold_scratch(n, int(dsum.shape[0]), vals),
                            sum(FOLD_STEPS.values()))
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
    one scatter of bucket rows.  The device never inserts, so shadow and
    table cannot diverge.  Capacity is a sticky pow2 high-water: growth
    rebuilds shadow and table at the doubled size, never shrinks.
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
        #: the table: int32 rows (lo, hi, slot1, 0)
        self.buckets = torch.zeros((cap, 4), dtype=torch.int32,
                                   device=self.device)
        self.tab_lo, self.tab_hi, self.tab_slot1, _ = self.buckets.unbind(1)

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

    @property
    def num_loaded(self) -> int:
        """Slots of the key index placed in the table so far."""
        return self._n

    def table(self):
        """The three planes of the JAX package's table, as column views of
        :attr:`buckets`."""
        return self.tab_lo, self.tab_hi, self.tab_slot1

    def prepare_batch(self, keys: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(key_lo, key_hi, start) int32 planes of a batch, as the JAX
        package's probe takes them (the probe lane here ships the int64
        keys and hashes on the card)."""
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
        """One scatter of whole bucket rows (in place; JAX donated its
        planes)."""
        rows = np.zeros((keys.size, 4), np.int32)
        rows[:, 0], rows[:, 1] = split_keys(keys)
        rows[:, 2] = slots1
        b = torch.from_numpy(np.ascontiguousarray(buckets, np.int64)).to(
            self.device)
        self.buckets[b] = torch.from_numpy(rows).to(self.device)

    def _grow(self, needed: int) -> None:
        """Sticky pow2 growth: double until ``needed`` fits the load factor,
        re-place every loaded key (read back from the old table's columns),
        upload."""
        cap = self.capacity
        while needed > int(cap * self._max_load):
            cap <<= 1
        if cap == self.capacity:
            return
        loaded = self._n
        old = self.buckets.cpu().numpy()
        occ = old[:, 2] > 0
        keys_u = (old[occ, 0].view(np.uint32).astype(np.uint64)
                  | (old[occ, 1].view(np.uint32).astype(np.uint64)
                     << np.uint64(32)))
        keys = keys_u.view(np.int64)
        slots1 = old[occ, 2]
        self._alloc(cap)
        self._n = loaded
        if keys.size:
            self._upload(self._place(keys), keys, slots1)


# ---------------------------------------------------------------------------
# measured A/B calibration (the device_probe="auto" verdict)
# ---------------------------------------------------------------------------

_calibrated_probe: Optional[bool] = None
_calib_lock = threading.Lock()
#: what the last measurement read: best host and device seconds a batch
#: (the chip smoke's report)
last_measurement: Dict[str, float] = {}

#: env override, under the JAX package's name: "on"/"off" skip the
#: measurement ("auto" measures)
_ENV = "FLINK_TPU_DEVICE_PROBE"


def calibrated_device_probe(device: DeviceLike = None) -> bool:
    """The MEASURED verdict, cached process-wide: does the probe lane (the
    card resolves warm keys and folds them into the delta ring) beat the C
    host pass?  The first operator to ask measures on its own ``device``;
    the answer then holds for the process.  ``FLINK_TPU_DEVICE_PROBE=on|off``
    skips the measurement."""
    global _calibrated_probe
    if _calibrated_probe is not None:
        return _calibrated_probe
    with _calib_lock:
        if _calibrated_probe is not None:
            return _calibrated_probe
        env = os.environ.get(_ENV, "").lower()
        if env in ("on", "1", "true"):
            _calibrated_probe = True
        elif env in ("off", "0", "false"):
            _calibrated_probe = False
        else:
            _calibrated_probe = _measure_device_probe(resolve_device(device))
        return _calibrated_probe


def _measure_device_probe(device: torch.device) -> bool:
    """A warm 32k-key table over real-sized batches.  Host side: the C
    probe + fold pass at the shard count the host lane would use.  Device
    side: what ``_probed_delta_step`` runs, the ``probe`` kernel and the
    ordered fold (``csrc/scatter_fold.cu``) into an f64 delta plane and
    int32 counts, each sample timing the key and value upload, the launches
    and the wait for the card.  One untimed round first builds the kernels
    and warms the card; on the CPU the same code runs the plain versions."""
    from flink_tpu_torch.kernels.build import host_mirror_lib
    from flink_tpu_torch.ops.scatter import ordered_fold_counts
    from flink_tpu_torch.state.keyindex import KeyIndex
    from flink_tpu_torch.state.native_mirror import (calibrated_shards,
                                                     measure_fused_probe)
    n_keys = 1 << 15
    B = 1 << 15
    rng = np.random.default_rng(23)
    keys_all = rng.integers(0, n_keys, 3 * B).astype(np.int64)
    vals_all = rng.random(3 * B).astype(np.float32)
    host_best = measure_fused_probe(host_mirror_lib(), calibrated_shards(),
                                    n_keys, B, keys_all, vals_all)

    ki = KeyIndex(initial_capacity=2 * n_keys)
    ki.lookup_or_insert(np.arange(n_keys, dtype=np.int64))
    dki = DeviceKeyIndex(initial_capacity=2 * n_keys, device=device)
    dki.ensure_loaded(ki)
    dsum = torch.zeros(n_keys, dtype=torch.float64, device=device)
    dcnt = torch.zeros(n_keys, dtype=torch.int32, device=device)

    def sample(i: int) -> float:
        t0 = time.perf_counter()
        keys = torch.from_numpy(keys_all[i * B:(i + 1) * B]).to(device)
        vals = torch.from_numpy(vals_all[i * B:(i + 1) * B]).to(device)
        slot = probe(dki.buckets, keys)
        ids = torch.where(slot >= 0, slot.to(torch.int64), n_keys)
        ordered_fold_counts((dsum,), dcnt, ids, (vals,), ("add",))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    sample(0)     # untimed: builds the kernels, as JAX's round 0 compiles
    dev_best = min(sample(i) for i in (1, 2))
    last_measurement.clear()
    last_measurement.update(host_s=host_best, device_s=dev_best)
    return dev_best < host_best

"""Native (C++) write-through window mirror (port of
``flink_tpu/state/native_mirror.py``).

Python face of the ``WinMirror`` entry points of ``csrc/host_mirror.cc``:
the host emit tier of :class:`~flink_tpu_torch.operators.window_agg.
WindowAggOperator` keeps a write-through host value mirror of the
accumulator cells, so fires and snapshots read no device state.  With
``native_emit=True`` that mirror lives in C:

- :meth:`NativeWindowMirror.probe_update` fuses the key-index probe and the
  mirror write-through into ONE C pass per block of rows, sharing the keydict
  of a :class:`~flink_tpu_torch.state.keyindex.NativeKeyIndex`, so slot ids
  agree with the device state rows by construction; under scatter sync the
  same pass writes the device scatter ids;
- :meth:`NativeWindowMirror.fire` is one sequential C sweep that combines a
  window's panes, compacts the non-empty rows and resolves their keys.

Eligibility (:func:`ineligible`): scalar accumulator leaves, add/min/max
combine kinds, f64/i64 mirror leaves.  Other accumulators keep the
operator's numpy mirror, as in the JAX package.

The shard count of the C pass is measured, not assumed
(:func:`calibrated_shards`, over :func:`measure_fused_probe`): on shared or
steal-heavy cores one thread's prefetching can already saturate memory and
extra shards lose.  ``FLINK_TPU_NATIVE_SHARDS`` pins it, under the JAX
package's name, so one environment pins both packages.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: numpy dtype -> native value-load tag (VDt in host_mirror.cc)
_VDT = {np.dtype(np.float64): 0, np.dtype(np.float32): 1,
        np.dtype(np.int64): 2, np.dtype(np.int32): 3}
_KINDS = {"add": 0, "min": 1, "max": 2}


def ineligible(spec, kinds: Optional[Sequence[str]],
               mirror_dtypes) -> Optional[str]:
    """Why this accumulator cannot live in the C mirror, or None if it can
    (the JAX package's ``try_create`` conditions)."""
    if kinds is None or not all(k in _KINDS for k in kinds):
        return f"combine kinds {kinds} are not all add/min/max"
    if any(tuple(s) != () for s in spec.leaf_shapes):
        return "non-scalar accumulator leaves"
    if any(np.dtype(d) not in (np.dtype(np.float64), np.dtype(np.int64))
           for d in mirror_dtypes):
        return f"mirror dtypes {mirror_dtypes} are not f64/i64"
    if not 1 <= spec.num_leaves <= 16:
        return f"{spec.num_leaves} accumulator leaves (1..16 fit)"
    return None


def auto_shards() -> int:
    """Default shard count of the C pass: one shard per core up to 4 (the
    pass is memory-latency bound; past a few cores the misses in flight
    saturate the memory controller).  ``FLINK_TPU_NATIVE_SHARDS``
    overrides."""
    env = os.environ.get("FLINK_TPU_NATIVE_SHARDS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    from flink_tpu_torch.kernels.build import host_mirror_lib
    cores = int(host_mirror_lib().ftt_hw_threads())  # the C pool's view
    return max(1, min(4, cores or os.cpu_count() or 1))


_calibrated_shards: Optional[int] = None
#: the last shard A/B's pass times in seconds by shard count (the chip
#: smoke's report)
last_shard_s: Dict[int, float] = {}
#: module-scope: creating the lock lazily would itself be a check-then-act
#: race between the first two calibrating threads
_calib_lock = threading.Lock()


def measure_fused_probe(lib, shards: int, n_keys: int, B: int,
                        keys_all: np.ndarray, vals_all: np.ndarray,
                        rounds: int = 3) -> float:
    """Best-of-``rounds`` wall seconds of the C probe + fold pass
    (``ftt_wm_probe_update2``) at ``shards`` over a warm ``n_keys``
    keydict: the measurement harness of the shard A/B, the super-batch
    calibration and the device-probe calibration.  ``keys_all`` and
    ``vals_all`` (f32) hold ``rounds`` consecutive batches of ``B``.  The
    throwaway keydict and mirror are freed even if the measurement
    fails."""
    d = lib.ftt_keydict_create(2 * n_keys)
    if not d:
        raise RuntimeError("ftt_keydict_create failed")
    h = None
    try:
        kind = (ctypes.c_uint8 * 1)(0)   # add
        lt = (ctypes.c_uint8 * 1)(0)     # f64 storage
        init = np.zeros(1, np.uint64)
        h = lib.ftt_wm_create(d, 1, kind, lt,
                              init.ctypes.data_as(ctypes.c_void_p))
        if not h:
            raise RuntimeError("ftt_wm_create failed")
        vdt = (ctypes.c_uint8 * 1)(_VDT[np.dtype(np.float32)])

        def run(keys, panes, vals, slots):
            vp = (ctypes.c_void_p * 1)(vals.ctypes.data)
            lib.ftt_wm_probe_update2(h, keys.ctypes.data, panes.ctypes.data,
                                     keys.size, vp, vdt, slots.ctypes.data,
                                     0, 0, 0, 0, shards, 0, 0)

        run(np.arange(n_keys, dtype=np.int64), np.zeros(n_keys, np.int64),
            np.zeros(n_keys, np.float32), np.empty(n_keys, np.int32))
        panes = np.zeros(B, np.int64)
        slots = np.empty(B, np.int32)
        best = float("inf")
        for i in range(rounds):
            k = np.ascontiguousarray(keys_all[i * B:(i + 1) * B], np.int64)
            v = np.ascontiguousarray(vals_all[i * B:(i + 1) * B], np.float32)
            t0 = time.perf_counter()
            run(k, panes, v, slots)
            best = min(best, time.perf_counter() - t0)
        return best
    finally:
        if h:
            lib.ftt_wm_destroy(h)
        lib.ftt_keydict_destroy(d)


def calibrated_shards() -> int:
    """The MEASURED shard count of the C pass, cached process-wide: the
    pass serially against :func:`auto_shards` threads on a throwaway
    keydict and mirror (tens of ms, once a process), the faster wins.
    ``FLINK_TPU_NATIVE_SHARDS`` skips the measurement."""
    global _calibrated_shards
    if _calibrated_shards is not None:
        return _calibrated_shards
    with _calib_lock:
        if _calibrated_shards is not None:
            return _calibrated_shards
        auto = auto_shards()
        if os.environ.get("FLINK_TPU_NATIVE_SHARDS") or auto <= 1:
            _calibrated_shards = auto
            return auto
        from flink_tpu_torch.kernels.build import host_mirror_lib
        n_keys = 1 << 15
        B = 1 << 15  # >= the C pass's parallel threshold
        rng = np.random.default_rng(17)
        keys_all = rng.integers(0, n_keys, 3 * B).astype(np.int64)
        vals_all = rng.random(3 * B).astype(np.float32)
        timings = {shards: measure_fused_probe(host_mirror_lib(), shards,
                                               n_keys, B, keys_all, vals_all)
                   for shards in (1, auto)}
        last_shard_s.clear()
        last_shard_s.update(timings)
        _calibrated_shards = min(timings, key=timings.get)
        return _calibrated_shards


def _value_ptrs(leaves, nl: int):
    """(kept arrays, ``void*[nl]``, ``u8[nl]`` value-load tags) of leaf
    columns: dtypes the C loads take pass as they are, others as f64."""
    arrs = []
    vdt = (ctypes.c_uint8 * nl)()
    for j, l in enumerate(leaves):
        a = np.ascontiguousarray(l)
        if a.dtype not in _VDT:
            a = a.astype(np.float64)
        arrs.append(a)
        vdt[j] = _VDT[a.dtype]
    return arrs, (ctypes.c_void_p * nl)(*[a.ctypes.data for a in arrs]), vdt


class NativeWindowMirror:
    """ctypes handle to a C++ WinMirror sharing a NativeKeyIndex's keydict."""

    def __init__(self, lib, key_index, handle, mirror_dtypes):
        self._lib = lib
        #: pins the key index (and thus the shared keydict) for our lifetime
        self._key_index = key_index
        self._h = handle
        self._mirror_dtypes = tuple(np.dtype(d) for d in mirror_dtypes)
        #: reusable fire output buffers (keys, counts, leaves): a 1M-key
        #: fire would otherwise first-touch ~24 MB of fresh pages a window
        self._fire_scratch = None
        #: reusable export buffers (counts, leaves), for the same reason
        self._export_scratch = None

    @classmethod
    def create(cls, key_index, spec, kinds: Sequence[str],
               mirror_dtypes) -> "NativeWindowMirror":
        """A mirror bound to ``key_index``'s keydict for this accumulator;
        raises ValueError if it is :func:`ineligible`."""
        why = ineligible(spec, kinds, mirror_dtypes)
        if why is not None:
            raise ValueError(f"the native window mirror cannot hold this "
                             f"accumulator: {why}")
        lib = key_index._lib
        mdts = [np.dtype(d) for d in mirror_dtypes]
        nl = spec.num_leaves
        kind_b = (ctypes.c_uint8 * nl)(*[_KINDS[k] for k in kinds])
        lt_b = (ctypes.c_uint8 * nl)(
            *[1 if d == np.dtype(np.int64) else 0 for d in mdts])
        init = np.empty(nl, np.uint64)
        for j, (iv, d) in enumerate(zip(spec.leaf_inits, mdts)):
            init[j] = np.asarray(iv).astype(d).reshape(1).view(np.uint64)[0]
        h = lib.ftt_wm_create(key_index.handle, nl, kind_b, lt_b,
                              init.ctypes.data_as(ctypes.c_void_p))
        if not h:
            raise RuntimeError("ftt_wm_create failed")
        return cls(lib, key_index, h, mdts)

    @classmethod
    def try_create(cls, key_index, spec, kinds: Optional[Sequence[str]],
                   mirror_dtypes) -> Optional["NativeWindowMirror"]:
        """:meth:`create`, or None where the mirror cannot serve: a key
        index without a C keydict, or an accumulator :func:`ineligible`
        names.  A host library that does not build still raises."""
        if getattr(key_index, "handle", None) is None or kinds is None \
                or ineligible(spec, kinds, mirror_dtypes) is not None:
            return None
        return cls.create(key_index, spec, kinds, mirror_dtypes)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            try:
                self._lib.ftt_wm_destroy(h)
            except Exception:  # noqa: BLE001 — interpreter teardown
                pass
            self._h = None

    # -- hot path ------------------------------------------------------------
    def probe_update(self, keys: np.ndarray, panes: np.ndarray,
                     lifted: List[np.ndarray], pane_mod: int = 0,
                     flat_out: Optional[np.ndarray] = None,
                     flat_fill: int = 0, shards: int = 1,
                     shard_div: int = 0,
                     shard_ns: Optional[np.ndarray] = None) -> np.ndarray:
        """Fused probe + mirror fold; returns the rows' int32 slot ids
        (unseen keys insert, numbered by first occurrence).  ``lifted`` is
        the aggregate's ``host_lift`` leaves, one [B] array per leaf.  When
        ``flat_out`` (contiguous int32, size >= B) is given, the pass also
        writes the device scatter ids ``slot * pane_mod + pane % pane_mod``
        into it and fills ``flat_out[B:]`` with ``flat_fill``.  ``shards`` >
        1 splits the pass over the C worker pool (from 2^14 rows; disjoint
        slot ownership, no locks), bit-identical to the serial pass at any
        count.  Ownership is ``slot % shards`` classes, or, with
        ``shard_div`` > 0, contiguous slot ranges of that length.
        ``shard_ns`` (contiguous int64, size >= shards) receives each
        shard's fold wall time in ns."""
        keys = np.ascontiguousarray(keys, np.int64)
        panes = np.ascontiguousarray(panes, np.int64)
        n = keys.size
        slots = np.empty(n, np.int32)
        if n == 0:
            if flat_out is not None:
                flat_out[:] = flat_fill
            if shard_ns is not None:
                shard_ns[:] = 0
            return slots
        arrs, vals, vdt = _value_ptrs(lifted, len(self._mirror_dtypes))
        flat_ptr = 0
        flat_cap = 0
        if flat_out is not None:
            # hard checks, not asserts: a wrong buffer here is memory
            # corruption in C, and pane_mod 0 a division by zero
            if (flat_out.dtype != np.int32 or not flat_out.flags.c_contiguous
                    or flat_out.size < n or pane_mod <= 0):
                raise ValueError(
                    "flat_out must be contiguous int32 with size >= n and "
                    "pane_mod > 0")
            flat_ptr = flat_out.ctypes.data
            flat_cap = flat_out.size
        ns_ptr = 0
        if shard_ns is not None:
            if (shard_ns.dtype != np.int64
                    or not shard_ns.flags.c_contiguous
                    or shard_ns.size < max(1, int(shards))):
                raise ValueError("shard_ns must be contiguous int64 with "
                                 "size >= shards")
            shard_ns[:] = 0
            ns_ptr = shard_ns.ctypes.data
        self._lib.ftt_wm_probe_update2(
            self._h, keys.ctypes.data, panes.ctypes.data, n, vals, vdt,
            slots.ctypes.data, pane_mod, flat_ptr, flat_cap,
            int(flat_fill), max(1, int(shards)), int(shard_div), ns_ptr)
        del arrs   # kept alive through the call
        return slots

    def apply_delta(self, pane: int, counts: np.ndarray,
                    leaves: List[np.ndarray]) -> None:
        """Fold a pane-granular DELTA (warm-key contributions accumulated on
        the card by the device key probe) into the mirror: counts add, each
        leaf combines by its kind.  Delta rows are identity-initialized, so
        untouched rows fold as no-ops."""
        counts = np.ascontiguousarray(counts, np.int64)
        arrs, ptrs, vdt = _value_ptrs(leaves, len(self._mirror_dtypes))
        self._lib.ftt_wm_apply_delta(self._h, int(pane), counts.size,
                                     counts.ctypes.data, ptrs, vdt)
        del arrs

    def fire(self, panes: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
        """Combine + compact the window's panes: (keys[m], counts[m], leaf
        arrays [m]) in ascending slot order."""
        n = self._key_index.num_keys
        panes = np.ascontiguousarray(panes, np.int64)
        if n == 0 or panes.size == 0:
            return (np.empty(0, np.int64), np.empty(0, np.int64),
                    [np.empty(0, d) for d in self._mirror_dtypes])
        sc = self._fire_scratch
        if sc is None or sc[0].size < n:
            cap = 1 << max(10, (n - 1).bit_length())
            sc = self._fire_scratch = (
                np.empty(cap, np.int64), np.empty(cap, np.int64),
                [np.empty(cap, d) for d in self._mirror_dtypes])
        out_keys, out_counts, out_leaves = sc
        ptrs = (ctypes.c_void_p * len(out_leaves))(
            *[a.ctypes.data for a in out_leaves])
        m = int(self._lib.ftt_wm_fire(self._h, panes.ctypes.data, panes.size,
                                      out_keys.ctypes.data,
                                      out_counts.ctypes.data, ptrs))
        # keys and leaves are copied out (emitted batches outlive this
        # call); counts are consumed or dropped by the caller: a view
        return (out_keys[:m].copy(), out_counts[:m],
                [a[:m].copy() for a in out_leaves])

    # -- pane lifecycle ------------------------------------------------------
    def drop_pane(self, pane: int) -> None:
        self._lib.ftt_wm_drop_pane(self._h, int(pane))

    def live_panes(self) -> np.ndarray:
        """Ids of the panes the mirror holds, ascending."""
        k = int(self._lib.ftt_wm_pane_count(self._h))
        out = np.empty(k, np.int64)
        if k:
            self._lib.ftt_wm_live_panes(self._h, out.ctypes.data)
        out.sort()
        return out

    # -- snapshots -----------------------------------------------------------
    def export_pane(self, pane: int, nrows: int
                    ) -> Tuple[bool, np.ndarray, List[np.ndarray]]:
        """(exists, counts[nrows] int64, leaf columns in the mirror dtypes).

        Returns VIEWS into reusable scratch, overwritten by the next export:
        callers consume them before exporting the next pane."""
        sc = self._export_scratch
        if sc is None or sc[0].size < nrows:
            cap = 1 << max(10, (nrows - 1).bit_length())
            sc = self._export_scratch = (
                np.empty(cap, np.int64),
                [np.empty(cap, d) for d in self._mirror_dtypes])
        counts, leaves = sc
        ptrs = (ctypes.c_void_p * len(leaves))(
            *[a.ctypes.data for a in leaves])
        ex = int(self._lib.ftt_wm_export_pane(self._h, int(pane), nrows,
                                              counts.ctypes.data, ptrs))
        return bool(ex), counts[:nrows], [a[:nrows] for a in leaves]

    def import_pane(self, pane: int, counts: np.ndarray,
                    leaves: List[np.ndarray]) -> None:
        """Overwrite the pane's first ``len(counts)`` rows (restore)."""
        counts = np.ascontiguousarray(counts, np.int64)
        arrs = [np.ascontiguousarray(l, d)
                for l, d in zip(leaves, self._mirror_dtypes)]
        ptrs = (ctypes.c_void_p * len(arrs))(*[a.ctypes.data for a in arrs])
        self._lib.ftt_wm_import_pane(self._h, int(pane), counts.size,
                                     counts.ctypes.data, ptrs)

"""Mesh-sharded window operators: the keyed exchange is the execution path
(port of ``flink_tpu/parallel/mesh_runtime.py``: ``MeshWindowAggOperator``,
and ``MeshSessionWindowOperator`` at the end of this module, whose session
fold rides the same exchange).

One logical :class:`~flink_tpu_torch.operators.window_agg.WindowAggOperator`
over a 1-D mesh (``parallel/mesh.py``): its ``[K, P]`` rings are D row
blocks, block ``d`` owning the contiguous key-slot range ``[d*K/D,
(d+1)*K/D)`` on ``mesh.devices[d]``.  A micro-batch's rows are split over
the positions as a distributed source would produce them (source ``s`` =
batch rows ``[s*Bp/D, (s+1)*Bp/D)``), each source sorts its rows into
per-destination buckets (a STABLE sort), the exchange moves bucket ``[s,
d]`` onto ``devices[d]`` and concatenates in source order, and each block
folds what it received in row order (``ops/scatter.py``
``ordered_fold_counts``; on the card ``csrc/scatter_fold.cu``, once per
block).  A key's rows keep their batch order all the way, so the fold adds
each cell's rows in the single-block order and the state is bit-equal at any
mesh size.

As in JAX, one process and one operator own every block (single-controller
SPMD): ``snapshot_state`` returns every shard's slice, restores rescale to
any mesh size, and four blocks can share one card.  The host computes every
record's destination (it assigns the key slots anyway), so each (source,
destination) bucket's capacity is known before the dispatch; it is a
sticky high-water, so a steady batch geometry reuses one exchange geometry
(:meth:`mesh_step_cache_size`).

Per-shard subsystems, on the same key-group-range layout
(``state/shard_layout.ShardLayout``):

- **host tier**: the C probe and mirror pass shards by contiguous slot
  range (``shard_div = ceil(K/S)``), so probe shard ``t`` maintains the
  mirror rows whose block is position ``t`` (per-shard wall times in
  ``phase_shard_ns``);
- **device probe**: one probe of the unsharded table on position 0
  (``csrc/probe.cu`` on the card); the slots come back to the host, the
  misses take the C pass, the warm rows fold into the sharded f64 delta ring
  through the exchange, and under scatter sync every row folds into the
  replica through it.  The one-step lane stays off (``_FUSED_SCAN``), so
  ``probe_fold`` is not on this path, as in JAX; super-batches stage
  through the concatenated host pass;
- **paging**: the ``DevicePager`` runs unchanged over global ring rows; a
  record's destination is its resident row's block, and page-out and
  page-in gather and set rows across blocks.  Paged snapshots stay dense;
- **degraded tier**: a quarantine degrades the WHOLE mesh: the live ring
  downloads block by block into the host value mirror, fires go on from it,
  and re-promotion at the checkpoint-aligned safe point rebuilds the D
  blocks;
- **snapshots** are per-shard slices with key-group-range manifests
  (``split_to_shard_slices``), which any mesh size restores.

Every dispatch runs under the watchdog (``{name}.device_probe``,
``{name}.delta_fold``, ``{name}.update_step``); the fence covers every card
that holds a block.  On one card the exchange crosses no interconnect: its
copies stay on the card.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional

import numpy as np
import torch

from flink_tpu_torch.core.functions import (canonical_tensor, tree_leaves,
                                            tree_structure, tree_unflatten)
from flink_tpu_torch.operators.session_window import SessionWindowOperator
from flink_tpu_torch.operators.window_agg import (WindowAggOperator,
                                                  _next_pow2, _PhaseTimer,
                                                  _take_rows)
from flink_tpu_torch.ops.scatter import ordered_fold_counts
from flink_tpu_torch.ops.shapes import quantize_pow2
from flink_tpu_torch.parallel.exchange import (all_to_all_rows, bucket_plan,
                                               bucket_rows)
from flink_tpu_torch.parallel.mesh import (DeviceMesh, layout_for, make_mesh,
                                           shard_rows, state_sharding)
from flink_tpu_torch.runtime.device_health import DeviceQuarantinedError
from flink_tpu_torch.state.device_keyindex import probe
from flink_tpu_torch.state.shard_layout import split_to_shard_slices
from flink_tpu_torch.utils import transport


def _quantize(n: int, floor: int = 16) -> int:
    """pow2/4-step rounding: few distinct geometries, <= 25% padding."""
    return quantize_pow2(n, floor=floor, steps=4)


class MeshWindowAggOperator(WindowAggOperator):
    """``WindowAggOperator`` as ONE logical operator over a 1-D key-group
    mesh: state split by key group into row blocks, records moved to their
    owning block by the bucketed exchange.  Takes the window operator's
    arguments plus ``mesh`` (or ``n_devices`` visible cards)."""

    _SHARDED_HOST_TIER = True
    _SHARDED_PAGING = True
    _SHARDED_DEGRADE = True
    #: the one-step lane stays off: the exchange routing (bucket plan,
    #: sticky capacity) is host-computed per block of rows.  Super-batch
    #: STAGING still applies through the concatenated host pass, so the C
    #: pass, the probe and the exchanges run once per super-batch
    _FUSED_SCAN = False

    def __init__(self, *args, mesh: Optional[DeviceMesh] = None,
                 n_devices: Optional[int] = None, **kwargs):
        if mesh is None:
            mesh = make_mesh(n_devices)
        self.mesh = mesh
        self.n_shards = mesh.size
        kwargs.setdefault("sharding", state_sharding(mesh))
        super().__init__(*args, **kwargs)
        #: per-shard probe timing buffer (the phase_shard_ns feed)
        self._shard_ns_buf = np.zeros(self.n_shards, np.int64)
        #: the sticky exchange capacity (rows a source sends a destination)
        self._exchange_cap_hw = 0
        #: the update step's distinct (padded rows, capacity) geometries
        self._exchange_geoms: set = set()

    # ---------------------------------------------------------------- layout
    def shard_layout(self):
        """The key-group-range layout (snapshots, the sharded C pass and
        the record route share it)."""
        return layout_for(self.mesh, self._K)

    def _probe_shards(self):
        """The C pass aligned with the mesh: by default one probe shard per
        position, owning the contiguous slot range ``[t*K/D, (t+1)*K/D)``.
        The ownership divisor follows the ACTUAL shard count (an explicit
        ``native_shards``, or the C pool's cap of 16), so the ranges stay
        balanced when S != D."""
        S = min(self.native_shards or self.n_shards, 16)  # C pool cap
        if self._shard_ns_buf.size < S:
            self._shard_ns_buf = np.zeros(S, np.int64)
        return S, -(-self._K // S), self._shard_ns_buf

    def _round_key_capacity(self, needed: int) -> int:
        """Key capacity stays a multiple of D (even blocks): the power of
        two rounds up to ``lcm(K, D)``, free for power-of-two meshes.  Paged
        state never grows."""
        if self._pager is not None:
            return self._K
        newK = _next_pow2(max(needed, self.n_shards), self._K)
        return newK * self.n_shards // math.gcd(newK, self.n_shards)

    def mesh_step_cache_size(self) -> int:
        """Distinct exchange geometries (padded rows, bucket capacity) the
        update step has run at: JAX's compile count of its sharded step.  A
        fixed batch geometry keeps it fixed (the capacity only grows)."""
        return len(self._exchange_geoms)

    # ------------------------------------------------------------- snapshots
    def snapshot_state(self):
        """Per-shard slices with key-group-range manifests instead of one
        dense array set (``densify_keyed_snapshot`` merges them back on
        restore).  Paged snapshots stay dense: their key-id space exceeds
        the ring and does not decompose by row block."""
        snap = super().snapshot_state()
        if "counts" in snap and self._pager is None:
            mp = getattr(getattr(self, "ctx", None), "max_parallelism", 128)
            snap = split_to_shard_slices(snap, self.shard_layout(), mp)
        return snap

    # ------------------------------------------------------------- exchange
    def _route_batch(self, values, B: int, slots: np.ndarray,
                     panes: np.ndarray):
        """Host routing of a block of rows: pad to a multiple of D (pad
        rows carry slot K and spread evenly over the destinations),
        destination ``min(slot // (K/D), D-1)``, the sticky bucket capacity,
        and the row-split upload (source ``s`` on ``devices[s]``).  Returns
        ``((dest, slots, panes, *value leaves), cap)``, each a list of D
        blocks."""
        D = self.n_shards
        K = self._K
        KD = K // D
        # pad to a multiple of D, quantized (then re-rounded: D may not be a
        # power of two)
        Bp = -(-_quantize(-(-B // D) * D, D) // D) * D

        def pad(a, fill, dtype):
            if Bp == B and a.dtype == dtype:
                return np.ascontiguousarray(a)
            out = np.full((Bp,) + a.shape[1:], fill, dtype)
            out[:B] = a[:B]
            return out

        slots_p = pad(slots, K, np.int32)
        panes_p = pad(panes, 0, np.int32)
        dest = np.minimum(slots_p // KD, D - 1).astype(np.int32)
        dest[B:] = np.arange(Bp - B) % D   # spread pad rows evenly
        # the most rows any (source, destination) pair sends, as a sticky
        # high-water: batch-to-batch skew wobble keeps the geometry
        most = max(int(np.bincount(src, minlength=D).max())
                   for src in dest.reshape(D, -1))
        cap = self._exchange_cap_hw = max(self._exchange_cap_hw,
                                          _quantize(most))
        host = [dest, slots_p, panes_p] + [
            pad(np.asarray(v), 0, np.asarray(v).dtype)
            for v in tree_leaves(values)]
        self.phase_bytes["h2d"] = (self.phase_bytes.get("h2d", 0)
                                   + sum(a.nbytes for a in host))
        return [shard_rows(a, self.mesh) for a in host], cap

    def _exchange(self, batch, cap: int, treedef):
        """Bucket every source's rows (stable) and move the buckets to
        their destinations: per position, its received (slots, panes,
        lifted value leaves), in source-then-row order."""
        D = self.n_shards
        dest, slots, panes, *values = batch
        sent = []
        for s, dev in enumerate(self.mesh.devices):
            with self._on_device(dev):
                order, flat, _valid = bucket_plan(dest[s], D, cap)
                sent.append([bucket_rows(slots[s], order, flat, D, cap,
                                         self._K),
                             bucket_rows(panes[s], order, flat, D, cap, 0)]
                            + [bucket_rows(v[s], order, flat, D, cap, 0)
                               for v in values])
        rx = [all_to_all_rows([b[j] for b in sent], self.mesh)
              for j in range(len(sent[0]))]
        out = []
        for d, dev in enumerate(self.mesh.devices):
            with self._on_device(dev):
                vals = tree_unflatten(treedef, [r[d] for r in rx[2:]])
                if self.kinds is None:
                    # the generic fold's values as JAX's step sees them
                    vals = self._generic_values(vals, rx[0][d].shape[0])
                out.append((rx[0][d], rx[1][d],
                            tuple(tree_leaves(self.agg.lift(vals)))))
        return out

    def _mesh_fold(self, leaves, counts, received) -> None:
        """Each block folds its received rows, in row order, on its own
        device: local flat id ``(slot - d*K/D) * P + pane``; rows of other
        blocks and pad rows take the dropped id ``(K/D) * P``.  An aggregate
        with no scatter kinds folds through ``scatter_generic`` over the
        local ids, as each of JAX's blocks does."""
        K = self._K
        for (lo, lb, cb), (r_slots, r_panes, lifted) in zip(
                self._row_blocks(leaves, counts), received):
            kd, P = cb.shape
            idt = torch.int32 if K * P < 2 ** 31 else torch.int64
            with self._on_device(cb.device):
                local = r_slots.to(idt) - lo
                ok = (r_slots < K) & (local >= 0) & (local < kd)
                lflat = torch.where(ok, local * P + r_panes.to(idt), kd * P)
                if self.kinds is None:
                    self._generic_fold(lb, cb, lflat, lifted)
                else:
                    ordered_fold_counts(*self._flat_state(lb, cb), lflat,
                                        lifted, self.kinds)

    def _mesh_update_step(self, received) -> None:
        """The exchanged rows folded into the replica's blocks."""
        self._mesh_fold(self._leaves, self._counts, received)

    def _mesh_delta_step(self, received) -> None:
        """The exchanged warm rows folded into the sharded delta ring (the
        mirror's dtypes: f64 sums, folded into the mirror pane by pane)."""
        self._mesh_fold(self._delta_leaves, self._delta_counts, received)

    def _mesh_probe_step(self, keys_t: torch.Tensor) -> np.ndarray:
        """The key probe of the unsharded table on position 0; the slots
        come back to the host (the routing is host-computed from them)."""
        return probe(self._dki.buckets, keys_t).cpu().numpy()

    def _exchange_dispatch(self, label: str, step, values, B: int,
                           slots: np.ndarray, panes: np.ndarray) -> None:
        """One guarded exchange dispatch: the routing, the uploads and the
        buckets in its prepare, ``step`` (the block folds) its write.
        ``panes`` are ring slots.  Raises :class:`DeviceQuarantinedError`
        for the caller to degrade."""
        leaves = [np.asarray(a) for a in tree_leaves(values)]
        mb = (8 * B + sum(a.nbytes for a in leaves)) / 1e6
        treedef = tree_structure(values)

        def prepare():
            # phase "exchange" (inside device_dispatch / device_probe): the
            # host routing, the uploads, the buckets and their copies
            with self._phase("exchange"):
                batch, cap = self._route_batch(values, B, slots, panes)
                if step == self._mesh_update_step:
                    self._exchange_geoms.add((int(batch[0][0].shape[0])
                                              * self.n_shards, cap))
                received = self._exchange(batch, cap, treedef)
            return lambda: step(received)
        if label == "update_step":
            self._guarded_update(prepare, B, leaves, mb)
        else:
            self._guarded(label, (self._K, self._P, _next_pow2(B, 64),
                                  tuple((a.dtype.str, a.shape[1:])
                                        for a in leaves)), mb, prepare)

    def _apply_update(self, values, B: int, slots: np.ndarray,
                      panes: np.ndarray) -> None:
        """The replica fold of a block of rows through the exchange
        (``{name}.update_step``)."""
        self._exchange_dispatch("update_step", self._mesh_update_step,
                                values, B, slots, panes)

    def _apply_delta_update(self, values, B: int, slots: np.ndarray,
                            panes: np.ndarray) -> None:
        """The probe lane's warm rows into the sharded delta ring through
        the exchange (``{name}.delta_fold``)."""
        self._exchange_dispatch("delta_fold", self._mesh_delta_step, values,
                                B, slots, panes)

    # ------------------------------------------------------------ hot paths
    def _staged_update(self, staging, flat: Optional[np.ndarray], values,
                       leaves, B: int, calibrating: bool) -> None:
        """The plain lane's replica fold (JAX's ``_update_step`` override):
        the flat ids (from the C pass's upload set, or host-built) split
        back into (slot, pane) and route to their blocks, one guarded
        dispatch.  The ids are read now, so the upload set is free at
        once."""
        t0 = time.perf_counter()
        ids = (flat if flat is not None else staging.flat_out(B))[:B]
        with self._phase("device_dispatch"):
            self._apply_update(values, B, ids // self._P, ids % self._P)
        if calibrating:
            for dev in self._state_devices():
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            transport.record_dispatch_cost(
                (ids.nbytes + sum(a.nbytes for a in leaves)) / 1e6,
                time.perf_counter() - t0)

    def _hot_stage_devprobe(self, keys: np.ndarray, panes: np.ndarray,
                            values, B: int) -> None:
        """Mesh probe lane: the probe on position 0 (its slots and misses
        back to the host), the C pass over the misses only, then the warm
        rows' delta fold and, under scatter sync, every row's replica fold,
        each through the exchange."""
        self._devprobe_begin()
        with self._phase("device_probe"):
            keys64 = np.ascontiguousarray(keys, np.int64)

            def prepare():
                keys_t = self._ids_to_device(keys64)
                return lambda: self._mesh_probe_step(keys_t)
            try:
                slots = self._guarded(
                    "device_probe",
                    ("mesh_devprobe", self._dki.capacity, _next_pow2(B, 64)),
                    12 * B / 1e6, prepare)
            except DeviceQuarantinedError as err:
                self._devprobe_degrade(err, keys, panes, values)
                return
            slots = np.array(slots, np.int32)
            mi = np.flatnonzero(slots < 0)
            self._dp_stats["probe_hits"] += B - mi.size
            self._dp_stats["probe_misses"] += mi.size
        panes_mod = (panes % self._P).astype(np.int32)
        if mi.size:
            slots[mi] = self._devprobe_absorb_misses(
                np.ascontiguousarray(keys[mi]),
                np.ascontiguousarray(panes[mi]), _take_rows(values, mi))
            hit = np.ones(B, bool)
            hit[mi] = False
            h_idx = np.flatnonzero(hit)
            h = (_take_rows(values, h_idx), int(h_idx.size), slots[h_idx],
                 panes_mod[h_idx])
        else:
            h_idx = None
            h = (values, B, slots, panes_mod)
        if h[1]:
            try:
                with self._phase("device_probe"):
                    self._apply_delta_update(*h)
            except DeviceQuarantinedError as err:
                # the warm rows never reached the delta: refold exactly
                # those on the host (the misses are in the mirror already)
                if h_idx is None:
                    self._devprobe_degrade(err, keys, panes, values)
                else:
                    self._devprobe_degrade(
                        err, np.ascontiguousarray(keys[h_idx]),
                        np.ascontiguousarray(panes[h_idx]), h[0])
                return
            self._delta_panes.update(int(p) for p in np.unique(
                panes if h_idx is None else panes[h_idx]).tolist())
        if self.device_sync_mode == "deferred":
            self._device_stale = True
            return
        try:
            with self._phase("device_dispatch"):
                self._apply_update(values, B, slots, panes_mod)
        except DeviceQuarantinedError as err:
            # every record is in the mirror already (delta + misses)
            self._devprobe_degrade(err)


class MeshSessionWindowOperator(SessionWindowOperator):
    """Session windows over a device mesh (port of JAX's
    ``MeshSessionWindowOperator``).

    - **Merge decisions stay on the host** (interval-set bookkeeping per
      key, the ``MergingWindowSet`` role), inherited unchanged from
      :class:`SessionWindowOperator`.
    - **The per-batch value FOLD rides the mesh**: the host sessionizes the
      batch (it needs the boundaries for its merge anyway), assigns each
      batch-local session to the shard owning its key (``slot % D``) and a
      shard-local session id, and ships (dest, sid, values) through the
      bucketed exchange (``parallel/exchange.py``); each destination block
      lifts what it received and folds it by session id: ``add`` leaves
      through ``ops/scatter.py`` ``ordered_fold_counts`` (the
      ``scatter_fold`` kernel on the card, one call a block), ``min``/
      ``max`` leaves with ``scatter_reduce_`` from the leaf's identity.
      Only the folded per-session accumulators come down.
    - **Row order.** A source is a contiguous chunk of the sorted rows and
      the bucketing is stable, so a session's rows reach its block in
      sorted order, the order JAX's CPU scatter folds them in; the ordered
      fold keeps it on the card, where an ``index_add_`` would not.
    - Snapshots stay the base class's raw-key row format: mesh-size
      independent.

    Generic combines (no scatter kinds) take the base class's host fold,
    as in JAX."""

    def __init__(self, *args, mesh: Optional[DeviceMesh] = None,
                 n_devices: Optional[int] = None, **kwargs):
        if mesh is None:
            mesh = make_mesh(n_devices)
        self.mesh = mesh
        self.n_shards = mesh.size
        super().__init__(*args, **kwargs)
        if self.kinds is not None and any(
                s != () for s, k in zip(self.spec.leaf_shapes, self.kinds)):
            raise NotImplementedError(
                "not in this slice of flink_tpu_torch: the mesh session fold "
                "takes scalar accumulator leaves")

    # ------------------------------------------------------------ device op
    def _mesh_fold(self, dest, sid, vleaves, treedef, cap: int,
                   cap_sess: int) -> List[List[torch.Tensor]]:
        """One sharded fold: each source buckets its rows by destination
        shard, the exchange moves bucket ``[s, d]`` to block ``d``, and each
        block folds what it received by its (host-assigned) shard-local
        session id.  ``dest``, ``sid`` and ``vleaves`` are lists of D row
        blocks; returns, per leaf, the D blocks' ``[cap_sess]``
        accumulators (in the lifted leaf's dtype, as JAX's)."""
        D = self.n_shards
        sent_sid, sent_vals = [], []
        for s in range(D):
            order, flat, _valid = bucket_plan(dest[s], D, cap)
            sent_sid.append(bucket_rows(sid[s], order, flat, D, cap,
                                        cap_sess))
            sent_vals.append([bucket_rows(v[s], order, flat, D, cap, 0)
                              for v in vleaves])
        rx_sid = all_to_all_rows(sent_sid, self.mesh)
        rx_vals = [all_to_all_rows([sv[j] for sv in sent_vals], self.mesh)
                   for j in range(len(vleaves))]
        out: List[List[torch.Tensor]] = [[] for _ in self.kinds]
        for d, dev in enumerate(self.mesh.devices):
            lifted = tree_leaves(self.agg.lift(tree_unflatten(
                treedef, [r[d] for r in rx_vals])))
            planes = [torch.full((cap_sess,), np.asarray(init).item(),
                                 dtype=l.dtype, device=dev)
                      for l, init in zip(lifted, self.spec.leaf_inits)]
            counts = torch.zeros(cap_sess, dtype=torch.int32, device=dev)
            # pad rows and unfilled bucket cells carry sid = cap_sess: the
            # fold drops ids outside [0, cap_sess)
            ordered_fold_counts(planes, counts, rx_sid[d].contiguous(),
                                [l.contiguous() for l in lifted], self.kinds)
            for j, p in enumerate(planes):
                out[j].append(p)
        return out

    # ------------------------------------------------------------ host side
    def _sessionize(self, slots, ts, values, bounds=None):
        if self.kinds is None:
            return super()._sessionize(slots, ts, values, bounds)  # host fold
        if self.distinct_column is not None and isinstance(values, dict):
            # the distinct column only feeds the HOST-side value sets; it
            # never ships through the exchange
            values = {k: v for k, v in values.items()
                      if k != self.distinct_column}
        order, s_slots, s_ts, sess_id, firsts, lasts = \
            bounds if bounds is not None else self._session_bounds(slots, ts)
        n_sess = int(firsts.size)
        b_key = s_slots[firsts]
        b_start = s_ts[firsts]
        b_end = s_ts[lasts] + self.gap

        with _PhaseTimer(self.phase_ns, "exchange"):
            D = self.n_shards
            b_dest = (b_key % D).astype(np.int32)
            # shard-local session numbering (0..n_d-1 per shard)
            counts = np.bincount(b_dest, minlength=D)
            base = np.zeros(D, np.int64)
            base[1:] = np.cumsum(counts)[:-1]
            sess_order = np.argsort(b_dest, kind="stable")
            b_local = np.empty(n_sess, np.int64)
            b_local[sess_order] = (np.arange(n_sess)
                                   - base[b_dest[sess_order]])
            cap_sess = _quantize(int(counts.max()))

            # per-row routing labels (rows in sorted order)
            row_dest = b_dest[sess_id]
            row_sid = b_local[sess_id].astype(np.int32)
            treedef = tree_structure(values)
            vleaves = [np.asarray(v)[order] for v in tree_leaves(values)]

            # pad rows to a multiple of D; pad rows carry sid = cap_sess
            # (the fold drops them)
            B = row_dest.size
            Bp = -(-_quantize(-(-B // D) * D, D) // D) * D

            def pad(a, fill, dtype):
                out = np.full((Bp,) + a.shape[1:], fill, dtype)
                out[:B] = a[:B]
                return out

            dest_p = pad(row_dest, 0, np.int32)
            dest_p[B:] = np.arange(Bp - B) % D
            sid_p = pad(row_sid, cap_sess, np.int32)
            src = np.repeat(np.arange(D), Bp // D)
            per_pair = np.bincount(src * D + dest_p, minlength=D * D)
            cap = _quantize(int(per_pair.max()))
            # the upload JAX's ``device_put`` makes: 64-bit values narrow
            # to 32 bits (x64 off)
            host = [torch.from_numpy(dest_p), torch.from_numpy(sid_p)] + [
                canonical_tensor(torch.from_numpy(pad(v, 0, v.dtype)))
                for v in vleaves]
            self.phase_bytes["h2d"] = (self.phase_bytes.get("h2d", 0)
                                       + sum(t.nbytes for t in host))
            dest_b, sid_b, *val_b = [shard_rows(t, self.mesh) for t in host]
        with _PhaseTimer(self.phase_ns, "device_dispatch"):
            folded = self._mesh_fold(dest_b, sid_b, val_b, treedef, cap,
                                     cap_sess)
        with _PhaseTimer(self.phase_ns, "d2h"):
            blocks = [torch.cat([b.cpu() for b in leaf]).numpy()
                      for leaf in folded]
        self.phase_bytes["d2h"] = (self.phase_bytes.get("d2h", 0)
                                   + sum(b.nbytes for b in blocks))
        # gather each session's folded acc from its shard block
        flat_idx = b_dest.astype(np.int64) * cap_sess + b_local
        accs = [l[flat_idx].astype(dt, copy=False)
                for l, dt in zip(blocks, self.spec.leaf_dtypes)]
        return b_key, b_start, b_end, accs

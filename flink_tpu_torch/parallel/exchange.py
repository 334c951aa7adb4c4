"""Keyed record exchange between mesh positions (port of
``flink_tpu/parallel/exchange.py``).

The reference moves records between parallel subtasks through a Netty
shuffle with credit-based flow control (``NettyMessage.java``,
``RemoteInputChannel.java:302``).  JAX's intra-pod equivalent is a bucketed
``all_to_all`` under ``shard_map``: each device sorts its local rows into
per-destination buckets of fixed capacity, and one collective rotates the
buckets over ICI.  Here one controller holds every position's rows: each
source block sorts its rows into ``[D, cap]`` buckets on its own device,
and destination ``d`` receives bucket ``[s, d]`` of every source ``s``,
copied onto ``devices[d]`` and concatenated in source order
(:func:`all_to_all_rows`).  Overflow is reported by the raw exchange and
handled by :class:`ResizingExchange`, which re-runs at doubled capacity
instead of dropping.

JAX computes all of this in XLA outside any Pallas kernel; these are plain
torch ops (a stable sort, a ``searchsorted``, an index put, copies).  Rows
of unfilled bucket cells carry a fill the receiving fold drops.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from flink_tpu_torch.parallel.mesh import DeviceMesh, shard_rows


def bucket_plan(dest: torch.Tensor, num_shards: int, cap: int):
    """The bucketing plan of every keyed exchange: STABLE-sort the local
    rows by destination and compute each row's cell in the ``[num_shards,
    cap]`` send buckets.

    Returns ``(order, flat, valid_src)``: ``order`` the stable row
    permutation, ``flat[i]`` the bucket cell of sorted row ``i`` (or the
    ``num_shards * cap`` drop sentinel once its destination's bucket is
    full), ``valid_src`` the in-capacity mask of the sorted rows.  The
    stability matters beyond determinism: a key's rows keep their batch
    order through the exchange, so the sharded fold adds each cell's rows
    in the single-block fold's order at any mesh size."""
    B = dest.shape[0]
    order = torch.sort(dest, stable=True).indices
    sdest = dest[order].contiguous()
    # each row's position within its destination's bucket
    idx_in_dest = (torch.arange(B, device=dest.device)
                   - torch.searchsorted(sdest, sdest, side="left"))
    valid_src = idx_in_dest < cap
    flat = torch.where(valid_src, sdest.to(torch.int64) * cap + idx_in_dest,
                       num_shards * cap)
    return order, flat, valid_src


def bucket_rows(a: torch.Tensor, order: torch.Tensor, flat: torch.Tensor,
                num_shards: int, cap: int, fill) -> torch.Tensor:
    """Place one row array into its ``[num_shards, cap, ...]`` send
    buckets under a :func:`bucket_plan`; unfilled cells carry ``fill``."""
    buf = torch.full((num_shards * cap + 1,) + tuple(a.shape[1:]), fill,
                     dtype=a.dtype, device=a.device)
    buf[flat] = a[order]   # the sentinel cell takes the overflow; cut below
    return buf[:-1].reshape((num_shards, cap) + tuple(a.shape[1:]))


def all_to_all_rows(bucketed: Sequence[torch.Tensor],
                    mesh: DeviceMesh) -> List[torch.Tensor]:
    """The keyed exchange: ``bucketed[s]`` is source ``s``'s ``[D, cap,
    ...]`` send buckets; returns, for each destination ``d``, its receive
    rows ``[D * cap, ...]`` on ``devices[d]``: bucket ``[s, d]`` of every
    source, concatenated in source order (JAX's ``lax.all_to_all`` with
    ``split_axis=0, concat_axis=0, tiled=True``)."""
    D = mesh.size
    out = []
    for d, dev in enumerate(mesh.devices):
        parts = [bucketed[s][d].to(dev) for s in range(D)]
        out.append(torch.cat(parts).reshape((D * parts[0].shape[0],)
                                            + tuple(parts[0].shape[1:])))
    return out


def _bucket_local(dest: torch.Tensor, leaves: Tuple[torch.Tensor, ...],
                  num_shards: int, cap: int):
    """Sort one source's rows into ``[num_shards, cap]`` buckets by
    destination: (bucketed leaves, valid mask ``[num_shards, cap]``,
    overflow count).  Rows past ``cap`` for a destination overflow (counted,
    not sent)."""
    order, flat, valid_src = bucket_plan(dest, num_shards, cap)
    out_leaves = tuple(bucket_rows(l, order, flat, num_shards, cap, 0)
                       for l in leaves)
    vmask = torch.zeros(num_shards * cap + 1, dtype=torch.bool,
                        device=dest.device)
    vmask[flat] = valid_src
    vmask = vmask[:-1].reshape(num_shards, cap)
    overflow = (~valid_src).sum()
    return out_leaves, vmask, overflow


def make_all_to_all_exchange(mesh: DeviceMesh, num_leaves: int, cap: int):
    """The exchange: ``fn(dest, *leaves)`` with row-split inputs (D blocks,
    or a global array that :func:`~flink_tpu_torch.parallel.mesh.shard_rows`
    splits): ``dest`` int32 destination position per row, ``leaves`` the
    ``[B, ...]`` value arrays.  Returns, per position, lists of D blocks:
    ``rx_leaves`` (one list per leaf of ``[D*cap, ...]`` received rows),
    ``rx_valid`` (``[D*cap]`` bool) and ``overflow`` (``[1]`` int, the
    local rows not sent)."""
    D = mesh.size

    def _exchange(dest, *leaves):
        dest = shard_rows(dest, mesh)
        leaves = [shard_rows(l, mesh) for l in leaves]
        sent, masks, overflow = [], [], []
        for s in range(D):
            b, vmask, ov = _bucket_local(dest[s], tuple(l[s] for l in leaves),
                                         D, cap)
            sent.append(b)
            masks.append(vmask)
            overflow.append(ov.reshape(1))
        rx = tuple(all_to_all_rows([b[j] for b in sent], mesh)
                   for j in range(num_leaves))
        return rx, all_to_all_rows(masks, mesh), overflow

    return _exchange


class ResizingExchange:
    """Zero-loss exchange: overflow BLOCKS and renegotiates capacity, it
    never drops (the reference's credit semantics: a sender without credit
    waits, ``RemoteInputChannel.java:302``; floating buffers grow under
    backlog, ``NettyShuffleEnvironmentOptions.java:167``).  The fixed-cap
    exchange is pure, so an overflowed round re-runs at double capacity
    with the same inputs; capacity only grows."""

    def __init__(self, mesh: DeviceMesh, num_leaves: int, cap: int,
                 max_cap: int = 1 << 20):
        self.mesh = mesh
        self.num_leaves = num_leaves
        self.cap = cap
        self.max_cap = max_cap
        self._fn = make_all_to_all_exchange(mesh, num_leaves, cap)

    def __call__(self, dest, *leaves):
        """-> (rx_leaves, rx_valid, cap_used).  Every input row is
        delivered exactly once; raises only if ``max_cap`` cannot hold the
        skew."""
        while True:
            rx, valid, overflow = self._fn(dest, *leaves)
            if max(int(o.max()) for o in overflow) == 0:
                return rx, valid, self.cap
            if self.cap >= self.max_cap:
                raise RuntimeError(
                    f"exchange overflow at max capacity {self.max_cap}: "
                    f"destination skew exceeds the configured buffer budget")
            self.cap = min(self.cap * 2, self.max_cap)
            self._fn = make_all_to_all_exchange(self.mesh, self.num_leaves,
                                                self.cap)

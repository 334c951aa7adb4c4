"""Sharding-aware keyed-state layout: one logical state, per-shard slices
(port of ``flink_tpu/state/shard_layout.py``; the snapshot format is the
JAX package's, key for key).

The mesh operator (``parallel/mesh_runtime.py``) keeps its ``[K, P, *leaf]``
pane ring as D row blocks: block ``d`` owns the CONTIGUOUS key-slot range
``[d*K/D, (d+1)*K/D)`` and lives on ``mesh.devices[d]``.  A mesh snapshot
carries **per-shard slices with key-group-range manifests**:

- each shard's slice comes from exactly the rows its block owns,
- a snapshot taken at N shards restores at M shards (M == 1 included) by
  re-slicing the manifest ranges, and
- every dense-format consumer keeps working through
  :func:`densify_keyed_snapshot`, which merges the slices back.

The slices tile ``[0, num_keys)`` in ascending shard order, so merging is a
concatenation and splitting a row slice: the layout never reorders keys.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np

from flink_tpu_torch.core import keygroups

#: snapshot keys of the sharded layout
SLICES_KEY = "shard_slices"
LAYOUT_KEY = "shard_layout"


@dataclass(frozen=True)
class ShardLayout:
    """Key-slot ownership of a 1-D mesh: shard ``d`` owns rows
    ``[d * K // D, (d+1) * K // D)`` of the ``[K, ...]`` state (``K``
    divisible by ``D``: the operator rounds its capacity up)."""

    n_shards: int
    K: int

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if self.K % self.n_shards:
            raise ValueError(
                f"key capacity {self.K} not divisible by {self.n_shards} "
                f"shards (round K up first)")

    @property
    def rows_per_shard(self) -> int:
        return self.K // self.n_shards

    def row_range(self, shard: int) -> Tuple[int, int]:
        kd = self.rows_per_shard
        return shard * kd, (shard + 1) * kd

    def shard_of_rows(self, rows: np.ndarray) -> np.ndarray:
        """Owning shard per global row id (out-of-range sentinel rows map
        onto the last shard, whose fold drops them)."""
        return np.minimum(np.asarray(rows, np.int64) // self.rows_per_shard,
                          self.n_shards - 1).astype(np.int32)

    def key_group_range(self, shard: int,
                        max_parallelism: int = 128) -> Tuple[int, int]:
        """The contiguous key-group range ``shard`` owns under the
        reference's assignment formula (manifest metadata)."""
        r = keygroups.key_group_ranges(max_parallelism, self.n_shards)[shard]
        return int(r.start), int(r.end)

    def route_keys(self, keys: np.ndarray,
                   max_parallelism: int = 128) -> np.ndarray:
        """Owning shard per RAW key (key hash -> murmur key group ->
        contiguous range)."""
        return keygroups.route_raw_keys(keys, self.n_shards, max_parallelism)


def split_to_shard_slices(snap: Dict[str, Any], layout: ShardLayout,
                          max_parallelism: int = 128) -> Dict[str, Any]:
    """Dense gid-indexed snapshot -> per-shard slices + manifest.  Shard
    ``d``'s slice is its row block intersected with the live rows ``[0,
    n)``; blocks past the live keys give zero-row slices, so the manifest
    lists every shard."""
    snap = dict(snap)
    counts = snap.pop("counts")
    leaves = snap.pop("leaves")
    n = int(counts.shape[0])
    slices: List[Dict[str, Any]] = []
    for d in range(layout.n_shards):
        lo, hi = layout.row_range(d)
        lo, hi = min(lo, n), min(hi, n)
        slices.append({
            "shard": d,
            "row_range": (int(lo), int(hi)),
            "key_groups": layout.key_group_range(d, max_parallelism),
            "counts": np.asarray(counts[lo:hi]),
            "leaves": [np.asarray(l[lo:hi]) for l in leaves],
        })
    snap[SLICES_KEY] = slices
    snap[LAYOUT_KEY] = {"n_shards": layout.n_shards, "K": layout.K,
                        "max_parallelism": int(max_parallelism),
                        "num_keys": n}
    return snap


def densify_keyed_snapshot(snap: Dict[str, Any]) -> Dict[str, Any]:
    """Merge per-shard slices back into the dense gid-indexed layout; a
    dense snapshot comes back unchanged, so every restore path can call it.
    Slices may arrive in any order; they are re-tiled by their manifest row
    ranges and must cover ``[0, num_keys)`` exactly."""
    if SLICES_KEY not in snap:
        return snap
    snap = dict(snap)
    slices = snap.pop(SLICES_KEY)
    meta = snap.pop(LAYOUT_KEY, None) or {}
    ordered = sorted(slices, key=lambda s: s["row_range"][0])
    n = int(meta.get("num_keys",
                     max((s["row_range"][1] for s in ordered), default=0)))
    expect = 0
    for s in ordered:
        lo, hi = s["row_range"]
        if lo != expect:
            raise ValueError(
                f"shard slices do not tile [0, {n}): gap/overlap at row "
                f"{expect} (next slice starts at {lo})")
        expect = hi
    if expect != n:
        raise ValueError(f"shard slices cover [0, {expect}) but the "
                         f"manifest says {n} keys")
    live = [s for s in ordered if s["counts"].shape[0]]
    if not live:
        first = ordered[0]
        snap["counts"] = np.asarray(first["counts"])
        snap["leaves"] = [np.asarray(l) for l in first["leaves"]]
        return snap
    snap["counts"] = np.concatenate([s["counts"] for s in live], axis=0)
    snap["leaves"] = [
        np.concatenate([s["leaves"][j] for s in live], axis=0)
        for j in range(len(live[0]["leaves"]))]
    return snap


def has_shard_slices(snap: Dict[str, Any]) -> bool:
    return SLICES_KEY in snap


def slice_manifest(snap: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The manifest rows (shard, row_range, key_groups) without the data."""
    return [{k: s[k] for k in ("shard", "row_range", "key_groups")}
            for s in snap.get(SLICES_KEY, ())]

"""Device mesh + key-group sharding (port of ``flink_tpu/parallel/mesh.py``).

The reference assigns contiguous key-group ranges to parallel subtasks
(``KeyGroupRangeAssignment.java:50-84``); here the same ranges map to the
positions of a 1-D mesh over axis ``"kg"``: keyed state is split along its
key-slot dimension into one row block per position, and the exchange moves
each record to the block that owns its key.  Rescaling re-slices the ranges
over another mesh.

JAX's mesh is a ``jax.sharding.Mesh`` of distinct devices driven by one
controller.  :class:`DeviceMesh` is its counterpart here: an ordered tuple
of ``torch.device``, position ``d`` holding block ``d``.  One process and
one operator own every block, as in JAX.  A device may repeat: four
positions on one card (``["cuda:0"] * 4``) run four blocks there, and the
CPU tests use ``["cpu"] * D``.  Nothing shrinks a mesh or moves it to the
CPU on its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from flink_tpu_torch import resolve_device
from flink_tpu_torch.core import keygroups
from flink_tpu_torch.state.shard_layout import ShardLayout

KG_AXIS = "kg"


@dataclass(frozen=True)
class DeviceMesh:
    """A 1-D mesh over :data:`KG_AXIS`: position ``d`` is ``devices[d]``."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct_devices(self) -> List[torch.device]:
        """Each device of the mesh once, in mesh order."""
        out: List[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """1-D mesh over the key-group axis.  ``devices`` as given (repeats
    allowed; ``"cuda"`` raises without a card); else the first
    ``n_devices`` visible cards (all of them for None), raising when fewer
    are visible."""
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        n = visible if n_devices is None else int(n_devices)
        if n < 1 or n > visible:
            raise RuntimeError(
                f"make_mesh({n_devices}) needs {max(n, 1)} CUDA devices and "
                f"{visible} are visible; pass devices=[...] (for example "
                f"['cpu'] * D) for a mesh of your own")
        devices = [torch.device("cuda", i) for i in range(n)]
    elif n_devices is not None and int(n_devices) != len(devices):
        raise ValueError(f"n_devices={n_devices} but {len(devices)} devices "
                         f"were given")
    return DeviceMesh(tuple(resolve_device(d) for d in devices))


@dataclass(frozen=True)
class KeyGroupSharding:
    """key group -> mesh position (contiguous ranges, the reference's
    ``computeOperatorIndexForKeyGroup``)."""

    max_parallelism: int
    num_shards: int

    def shard_of_key_group(self, kg: np.ndarray) -> np.ndarray:
        kg = np.asarray(kg, np.int64)
        return (kg * self.num_shards // self.max_parallelism).astype(np.int32)

    def shard_of_keys(self, keys: np.ndarray) -> np.ndarray:
        kg = keygroups.assign_to_key_group(keygroups.hash_keys(keys),
                                           self.max_parallelism)
        return self.shard_of_key_group(kg)

    def ranges(self) -> List[keygroups.KeyGroupRange]:
        return keygroups.key_group_ranges(self.max_parallelism,
                                          self.num_shards)


@dataclass(frozen=True)
class StateSharding:
    """Placement of ``[K, ...]`` state over ``mesh``: the key-slot
    dimension split into one row block per position (JAX's
    ``NamedSharding(mesh, P("kg"))``)."""

    mesh: DeviceMesh


def state_sharding(mesh: DeviceMesh) -> StateSharding:
    """Sharding for ``[K_total, ...]`` state: key-slot dim split over the
    mesh."""
    return StateSharding(mesh)


def layout_for(mesh: DeviceMesh, K: int) -> ShardLayout:
    """The key-group-range layout of a ``[K, ...]`` state over ``mesh``:
    position ``d`` owns rows ``[d*K/D, (d+1)*K/D)``, the single source of
    row ownership for snapshots, the sharded probe and the record route
    (``dest = slot // (K/D)``)."""
    return ShardLayout(mesh.size, K)


def shard_rows(x, mesh: DeviceMesh) -> List[torch.Tensor]:
    """A row-split global array: ``x`` (tensor or numpy, leading dim a
    multiple of D) -> D equal row blocks, block ``d`` on ``devices[d]``,
    as ``jax.device_put`` with the row sharding places it.  A list of D
    blocks passes through."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.size:
            raise ValueError(f"{len(x)} blocks for a mesh of {mesh.size}")
        return list(x)
    t = torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray)
                        else x)
    if t.shape[0] % mesh.size:
        raise ValueError(f"{t.shape[0]} rows do not split over "
                         f"{mesh.size} devices")
    return [b.to(dev) for b, dev in zip(t.chunk(mesh.size), mesh.devices)]


def unshard_rows(blocks: Sequence[torch.Tensor]) -> torch.Tensor:
    """The global array of row blocks, concatenated on the CPU."""
    return torch.cat([b.cpu() for b in blocks])

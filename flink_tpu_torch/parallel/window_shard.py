"""Multi-device windowed aggregation: the sharding-aware operator factories
(port of ``flink_tpu/parallel/window_shard.py``).

:func:`sharded_window_operator` fronts the mesh runtime
(``parallel/mesh_runtime.MeshWindowAggOperator``): one logical window
operator whose state is key-group-range row blocks, one per mesh position,
whose records reach their owning block through the bucketed exchange
(``parallel/exchange.py``), whose C probe and mirror pass shards by the same
slot ranges, and whose snapshots are per-shard slices that rescale across
mesh sizes.

:func:`placement_sharded_window_operator` keeps the placement-only
construction for A/B comparisons: the single-device operator's logic over
one state placed as row blocks (every block folds the rows of its range,
fires gather every block), with no exchange, no host tier, no paging.
"""

from __future__ import annotations

from typing import Optional

from flink_tpu_torch.operators.window_agg import WindowAggOperator
from flink_tpu_torch.parallel.mesh import DeviceMesh, make_mesh, state_sharding


def sharded_window_operator(mesh: Optional[DeviceMesh] = None, *,
                            n_devices: Optional[int] = None,
                            **kwargs) -> WindowAggOperator:
    """A window operator whose keyed state, probe pass and record route are
    sharded over ``mesh`` (the mesh runtime); the other
    ``WindowAggOperator`` keyword arguments pass through."""
    from flink_tpu_torch.parallel.mesh_runtime import MeshWindowAggOperator
    if mesh is None:
        mesh = make_mesh(n_devices)
    return MeshWindowAggOperator(mesh=mesh, **kwargs)


def placement_sharded_window_operator(mesh: Optional[DeviceMesh] = None, *,
                                      n_devices: Optional[int] = None,
                                      **kwargs) -> WindowAggOperator:
    """The single-device operator with its state placed as row blocks over
    ``mesh`` (``sharding=state_sharding(mesh)``); kept for A/B tests."""
    if mesh is None:
        mesh = make_mesh(n_devices)
    return WindowAggOperator(sharding=state_sharding(mesh), **kwargs)

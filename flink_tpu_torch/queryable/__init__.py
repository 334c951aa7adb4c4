"""The queryable serving tier (port of ``flink_tpu/queryable``): live views,
checkpoint replicas, the hot-key cache, the wire codec and the TCP server."""

from flink_tpu_torch.queryable.cache import HotKeyCache
from flink_tpu_torch.queryable.replica import (CheckpointReplica,
                                               QueryableStateSpec, ReplicaGroup)
from flink_tpu_torch.queryable.server import (KvStateRegistry, QueryableStateClient,
                                              QueryableStateClientPool,
                                              QueryableStateServer)
from flink_tpu_torch.queryable.service import QueryableStateService
from flink_tpu_torch.queryable.view import WindowReadView

__all__ = ["KvStateRegistry", "QueryableStateClient",
           "QueryableStateClientPool", "QueryableStateServer",
           "QueryableStateService", "QueryableStateSpec",
           "CheckpointReplica", "ReplicaGroup", "HotKeyCache",
           "WindowReadView"]

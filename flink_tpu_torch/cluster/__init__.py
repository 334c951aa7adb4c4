"""The cluster runtime (port of ``flink_tpu/cluster``): channels, subtasks,
failover, the in-process MiniCluster and its control-plane pieces (RPC,
heartbeats), the process cluster (``distributed``: a coordinator and its
worker processes, started as ``python -m flink_tpu_torch worker``), its
TCP data plane (``net``), high availability (``ha``), the coordination
endpoints of a session cluster (``coordination``) and adaptive scheduling
with the reactive autoscaler (``adaptive``).

The process cluster's coordinator resolves its device once and ships it to
every worker it spawns (``--device``); a worker's environments and
operators that name no device take it, and a worker told ``cuda`` that
sees no card fails its start.
"""

"""The in-process cluster runtime: channels, subtasks, failover, the
MiniCluster, its control-plane pieces (RPC, heartbeats) and the restore
guard of adaptive scheduling.

The multi-process half of ``flink_tpu/cluster`` (the process cluster, its
network layer, HA and coordination) comes with the distributed runtime
(ROADMAP Queue A item 8.4b): reaching one of those modules through this
package raises ``NotImplementedError`` naming that item.
"""

#: the cluster modules of the JAX package that a later slice brings
LATER = {
    name: f"the {name} module comes with the distributed runtime (8.4b)"
    for name in ("distributed", "net", "ha", "coordination")
}


def __getattr__(name: str):
    if name in LATER:
        raise NotImplementedError(f"not in this slice of flink_tpu_torch: "
                                  f"{LATER[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

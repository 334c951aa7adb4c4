"""Connectors: sources, sinks, the file source, the split enumerators, the
Kafka wire connector (``kafka``, ``kafka_v2``) and the partitioned log.

The Postgres connector of ``flink_tpu/connectors`` comes with the host-only
edges (ROADMAP Queue A item 12): importing it from this package raises
``NotImplementedError`` naming that item, and so does the SQL DDL that
would reach it.
"""

#: the connector modules of the JAX package that a later slice brings
LATER = {
    "postgres": "the Postgres connector comes with the host-only edges (12)",
}


def later_connector(name: str) -> NotImplementedError:
    return NotImplementedError(f"not in this slice of flink_tpu_torch: "
                               f"{LATER[name]}")


def __getattr__(name: str):
    if name in LATER:
        raise later_connector(name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

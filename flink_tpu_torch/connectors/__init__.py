"""Connectors: sources, sinks, the file source and the split enumerators.

The external systems' connectors of ``flink_tpu/connectors`` (Kafka,
Postgres, the partitioned log, ...) come with the host-only edges (ROADMAP
Queue A item 12): importing one from this package raises
``NotImplementedError`` naming that item, and so does the SQL DDL that
would reach it.
"""

#: the connector modules of the JAX package that a later slice brings
LATER = {
    "kafka": "the Kafka connector comes with the host-only edges (12)",
    "postgres": "the Postgres connector comes with the host-only edges (12)",
    "partitioned_log": "the partitioned log connector comes with the "
                       "host-only edges (12)",
}


def later_connector(name: str) -> NotImplementedError:
    return NotImplementedError(f"not in this slice of flink_tpu_torch: "
                               f"{LATER[name]}")


def __getattr__(name: str):
    if name in LATER:
        raise later_connector(name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

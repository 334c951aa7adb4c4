"""Remote filesystems for checkpoint storage.

The S3 client, its S3-compatible server and ``S3CheckpointStorage``
(``flink_tpu/filesystems/s3.py``) come with the host-only edges (ROADMAP
Queue A item 12): reaching ``s3`` through this package raises
``NotImplementedError`` naming that item.  The object store of
``runtime/checkpoint/objectstore.py`` is the port's remote storage.
"""

#: the filesystem modules of the JAX package that a later slice brings
LATER = {"s3": "S3 storage comes with the host-only edges (12)"}


def __getattr__(name: str):
    if name in LATER:
        raise NotImplementedError(f"not in this slice of flink_tpu_torch: "
                                  f"{LATER[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

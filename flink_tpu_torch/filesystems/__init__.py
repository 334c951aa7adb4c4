"""Pluggable filesystem protocols (``flink-filesystems/`` analog; the
port's copy of ``flink_tpu/filesystems``).

``s3``: an AWS-Signature-V4 S3 client, an S3-compatible server facade over
the object store of ``runtime/checkpoint/objectstore.py``, and
``S3CheckpointStorage`` over the client.
"""

from flink_tpu_torch.filesystems.s3 import (S3Client, S3CompatibleServer,
                                            S3SignatureError, sign_v4)

__all__ = ["S3Client", "S3CompatibleServer", "S3SignatureError", "sign_v4"]

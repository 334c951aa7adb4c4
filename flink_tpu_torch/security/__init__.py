"""Transport security: mutual TLS and the shared-secret HMAC handshake of
the process cluster's control and data planes (port of
``flink_tpu/security``).

SCRAM (``security/scram.py``) serves only the Kafka and Postgres
connectors, which come with the host-only edges (ROADMAP Queue A item
12): reaching it through this package raises ``NotImplementedError``
naming that item.
"""

from flink_tpu_torch.security.ssl_context import (SecurityConfig,
                                                  generate_self_signed,
                                                  load_security_config)

__all__ = ["SecurityConfig", "generate_self_signed", "load_security_config"]

#: the security modules of the JAX package that a later slice brings
LATER = {"scram": "SCRAM comes with the Kafka and Postgres connectors of "
                  "the host-only edges (12)"}


def __getattr__(name: str):
    if name in LATER:
        raise NotImplementedError(f"not in this slice of flink_tpu_torch: "
                                  f"{LATER[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

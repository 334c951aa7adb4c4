"""Transport security: mutual TLS and the shared-secret HMAC handshake of
the process cluster's control and data planes, and SCRAM-SHA-256
(``security/scram.py``) for the Kafka connector (port of
``flink_tpu/security``).
"""

from flink_tpu_torch.security.ssl_context import (SecurityConfig,
                                                  generate_self_signed,
                                                  load_security_config)

__all__ = ["SecurityConfig", "generate_self_signed", "load_security_config"]

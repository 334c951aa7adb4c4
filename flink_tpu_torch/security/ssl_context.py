"""Transport security: mutual TLS + shared-secret auth for every listener
(port of ``flink_tpu/security/ssl_context.py``, host Python as JAX's).

Analog of the reference's SSL layer (``SecurityOptions.java`` in flink-core:
``security.ssl.internal.enabled`` for RPC/data/blob traffic and
``security.ssl.rest.enabled`` for the REST endpoint, with keystore/truststore
pairs; setup in ``flink-runtime/.../net/SSLUtils.java``).  Redesigned for the
Python runtime:

- **internal TLS** (data plane ``cluster/net.py``, control plane
  ``cluster/distributed.py``) is MUTUAL: both sides present a certificate
  signed by the cluster CA and verify the peer against it — the reference's
  identical-keystore/truststore internal SSL.
- **REST TLS** is server-only by default (browsers/CLIs connect with the CA
  as trust root), mirroring ``security.ssl.rest.*``.
- an optional **shared auth token** (HMAC over a per-connection nonce) guards
  the coordinator control plane even without TLS — the Kerberos/JAAS slot in
  the reference's security stack, reduced to the single-cluster secret that
  actually protects job submission here.

Certificates are plain PEM files (``ssl_cert`` / ``ssl_key`` / ``ssl_ca``);
:func:`generate_self_signed` mints a CA + node cert for tests and
single-host clusters (the reference ships the same convenience through its
``SSLUtils`` test helpers).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import ssl
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class SecurityConfig:
    """Resolved security settings (``SecurityOptions`` analog)."""

    internal_ssl: bool = False
    rest_ssl: bool = False
    cert_path: Optional[str] = None
    key_path: Optional[str] = None
    ca_path: Optional[str] = None
    auth_token: Optional[str] = None

    # -- contexts ----------------------------------------------------------
    def server_context(self, mutual: bool = True) -> Optional[ssl.SSLContext]:
        if not (self.internal_ssl if mutual else self.rest_ssl):
            return None
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.cert_path, self.key_path)
        if mutual:
            ctx.load_verify_locations(self.ca_path)
            ctx.verify_mode = ssl.CERT_REQUIRED
        return ctx

    def client_context(self, mutual: bool = True) -> Optional[ssl.SSLContext]:
        if not (self.internal_ssl if mutual else self.rest_ssl):
            return None
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_verify_locations(self.ca_path)
        # single-host clusters use IP peers; identity is the cluster CA
        ctx.check_hostname = False
        if mutual:
            ctx.load_cert_chain(self.cert_path, self.key_path)
        return ctx

    # -- token auth --------------------------------------------------------
    def sign(self, nonce: bytes) -> bytes:
        """HMAC-SHA256 over a nonce with the cluster secret."""
        assert self.auth_token is not None
        return hmac.new(self.auth_token.encode(), nonce,
                        hashlib.sha256).digest()

    def verify(self, nonce: bytes, mac: bytes) -> bool:
        return hmac.compare_digest(self.sign(nonce), mac)


def load_security_config(conf) -> SecurityConfig:
    """Build a :class:`SecurityConfig` from a ``Configuration``
    (``SecurityOptions`` keys, see ``config/options.py``)."""
    from flink_tpu_torch.config.options import SecurityOptions as S

    return SecurityConfig(
        internal_ssl=conf.get(S.SSL_INTERNAL_ENABLED),
        rest_ssl=conf.get(S.SSL_REST_ENABLED),
        cert_path=conf.get(S.SSL_CERT) or None,
        key_path=conf.get(S.SSL_KEY) or None,
        ca_path=conf.get(S.SSL_CA) or None,
        auth_token=conf.get(S.AUTH_TOKEN) or None)


def generate_self_signed(out_dir: str,
                         common_name: str = "flink-tpu") -> Tuple[str, str, str]:
    """Mint a CA plus one node certificate signed by it; returns
    ``(cert_path, key_path, ca_path)``.  Every cluster process shares the
    pair — the reference's identical internal keystore/truststore model."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    os.makedirs(out_dir, exist_ok=True)
    now = datetime.datetime.now(datetime.timezone.utc)

    def _name(cn):
        return x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])

    ca_key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    ca_cert = (x509.CertificateBuilder()
               .subject_name(_name(f"{common_name}-ca"))
               .issuer_name(_name(f"{common_name}-ca"))
               .public_key(ca_key.public_key())
               .serial_number(x509.random_serial_number())
               .not_valid_before(now - datetime.timedelta(minutes=5))
               .not_valid_after(now + datetime.timedelta(days=365))
               .add_extension(x509.BasicConstraints(ca=True, path_length=0),
                              critical=True)
               .sign(ca_key, hashes.SHA256()))

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    cert = (x509.CertificateBuilder()
            .subject_name(_name(common_name))
            .issuer_name(ca_cert.subject)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=365))
            .add_extension(x509.SubjectAlternativeName(
                [x509.DNSName("localhost"),
                 x509.IPAddress(__import__("ipaddress").ip_address(
                     "127.0.0.1"))]), critical=False)
            .sign(ca_key, hashes.SHA256()))

    paths = (os.path.join(out_dir, "node.crt"),
             os.path.join(out_dir, "node.key"),
             os.path.join(out_dir, "ca.crt"))
    with open(paths[0], "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    with open(paths[1], "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption()))
    with open(paths[2], "wb") as f:
        f.write(ca_cert.public_bytes(serialization.Encoding.PEM))
    return paths

"""SCRAM-SHA-256 (RFC 5802/7677) message-level state machines (port of
``flink_tpu/security/scram.py``: the same messages, byte for byte).

One implementation of the salted-challenge math shared by every
SCRAM-speaking protocol in the repo: the PostgreSQL wire handshake
(SASL authentication codes 10/11/12) and the Kafka SASL/SCRAM mechanism
(SaslAuthenticate token exchange).  Transport-agnostic: callers move the
RFC's client-first / server-first / client-final / server-final strings
over their own framing.

Mutual authentication: the client proves the password via ClientProof
(the server checks it against the STORED key without learning the
password from the exchange), and the server proves it knows the password
via ServerSignature, which the client verifies."""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
from typing import Dict, Optional, Tuple


def _h(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def _hmac(key: bytes, msg: bytes) -> bytes:
    return hmac.new(key, msg, hashlib.sha256).digest()


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _attrs(msg: str) -> Dict[str, str]:
    return dict(p.split("=", 1) for p in msg.split(","))


def _saslname_escape(name: str) -> str:
    """RFC 5802 saslname: '=' and ',' must transit as =3D / =2C."""
    return name.replace("=", "=3D").replace(",", "=2C")


def _saslname_unescape(name: str) -> str:
    return name.replace("=2C", ",").replace("=3D", "=")


class ScramClient:
    """Client half: ``first()`` → send; feed the server-first message to
    ``final()`` → send; feed the server-final message to ``verify()``."""

    def __init__(self, username: str, password: str):
        self.username = username
        self.password = password
        self._cnonce = _b64(os.urandom(18))
        self._bare = f"n={_saslname_escape(username)},r={self._cnonce}"
        self._server_sig: Optional[bytes] = None

    def first(self) -> str:
        return "n,," + self._bare

    def final(self, server_first: str) -> str:
        a = _attrs(server_first)
        nonce, salt, iters = a["r"], base64.b64decode(a["s"]), int(a["i"])
        if not nonce.startswith(self._cnonce):
            raise ValueError("SCRAM nonce mismatch (not our challenge)")
        salted = hashlib.pbkdf2_hmac("sha256", self.password.encode(),
                                     salt, iters)
        client_key = _hmac(salted, b"Client Key")
        stored_key = _h(client_key)
        without_proof = f"c=biws,r={nonce}"
        auth_msg = f"{self._bare},{server_first},{without_proof}".encode()
        proof = bytes(a ^ b for a, b in
                      zip(client_key, _hmac(stored_key, auth_msg)))
        self._server_sig = _hmac(_hmac(salted, b"Server Key"), auth_msg)
        return f"{without_proof},p={_b64(proof)}"

    def verify(self, server_final: str) -> None:
        got = base64.b64decode(_attrs(server_final).get("v", ""))
        if self._server_sig is None \
                or not hmac.compare_digest(got, self._server_sig):
            raise ValueError("SCRAM server signature verification failed "
                             "(peer does not know the password)")


class ScramServer:
    """Server half: feed the client-first message + the user's password to
    ``first_response()`` → send; feed the client-final message to
    ``verify_final()`` → (ok, server-final to send)."""

    def __init__(self, iterations: int = 4096):
        self.iterations = iterations
        self._server_first: Optional[str] = None
        self._bare: Optional[str] = None
        self._snonce: Optional[str] = None
        self._salted: Optional[bytes] = None

    @staticmethod
    def username_of(client_first: str) -> str:
        bare = client_first.split(",", 2)[2]
        # n=<saslname> ends at the ,r= attribute (escaped commas inside
        # the name transit as =2C, so this split is unambiguous)
        name = bare.split(",r=", 1)[0]
        if not name.startswith("n="):
            raise ValueError("malformed client-first message")
        return _saslname_unescape(name[2:])

    def first_response(self, client_first: str,
                       password: Optional[str] = None, *,
                       salt: Optional[bytes] = None,
                       salted: Optional[bytes] = None) -> str:
        """Build the server-first message.  Either pass the ``password``
        (the salted key is derived here — one PBKDF2 per handshake, fresh
        random salt), or pass ``salt`` + ``salted`` directly: credential
        stores keep a STABLE per-user salt and cache the salted password,
        so repeated (including unauthenticated) handshakes stop costing a
        fresh 4096-iteration PBKDF2 — and unknown-user handshakes can be
        served with a deterministic decoy salt that never touches a real
        credential (no username enumeration)."""
        self._bare = client_first.split(",", 2)[2]
        cnonce = _attrs(self._bare)["r"]
        if salted is not None:
            if salt is None:
                raise ValueError("salted requires its salt")
            self._salted = salted
        else:
            if password is None:
                raise ValueError("need password or (salt, salted)")
            salt = os.urandom(16) if salt is None else salt
            self._salted = hashlib.pbkdf2_hmac(
                "sha256", password.encode(), salt, self.iterations)
        self._snonce = cnonce + _b64(os.urandom(18))
        self._server_first = (f"r={self._snonce},s={_b64(salt)},"
                              f"i={self.iterations}")
        return self._server_first

    def verify_final(self, client_final: str) -> Tuple[bool, str]:
        a = _attrs(client_final)
        proof = base64.b64decode(a["p"])
        without_proof = client_final.rsplit(",p=", 1)[0]
        if a.get("r") != self._snonce:
            return False, ""
        client_key = _hmac(self._salted, b"Client Key")
        stored_key = _h(client_key)
        auth_msg = (f"{self._bare},{self._server_first},"
                    f"{without_proof}").encode()
        sig = _hmac(stored_key, auth_msg)
        recovered = bytes(x ^ y for x, y in zip(proof, sig))
        if not hmac.compare_digest(_h(recovered), stored_key):
            return False, ""
        server_sig = _hmac(_hmac(self._salted, b"Server Key"), auth_msg)
        return True, f"v={_b64(server_sig)}"

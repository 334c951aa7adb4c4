"""S3 protocol: AWS Signature Version 4 client + S3-compatible server.

The port's copy of ``flink_tpu/filesystems/s3.py``: host Python as JAX's,
the same bytes on the wire and on disk, so either package's client talks to
the other's server.

The reference's S3 filesystems (``flink-filesystems/flink-s3-fs-base/``)
speak the real S3 REST dialect so a job can point at any existing bucket.
This module does the same from first principles — no SDK:

- :func:`sign_v4` implements the documented SigV4 signing process
  (canonical request → string to sign → derived signing key → signature),
  verified against the AWS-published example vector in the tests.
- :class:`S3Client` — path-style PUT/GET/DELETE object + ListObjectsV2
  (XML) against ANY S3-compatible endpoint (AWS, MinIO, this module's
  server), signing every request and sending
  ``x-amz-content-sha256``.
- :class:`S3CompatibleServer` — serves the same dialect over a local
  directory: third-party S3 clients can read/write the framework's
  buckets; incoming signatures are verified by reconstructing the
  canonical request server-side (shared-credential model) and the payload
  hash is checked against the body.
- :class:`S3CheckpointStorage` — the checkpoint-storage seam
  (``runtime/checkpoint``) over the S3 dialect.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import threading
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Dict, List, Optional, Tuple

from flink_tpu_torch.runtime.checkpoint.objectstore import (
    ObjectStoreCheckpointStorage)
from flink_tpu_torch.utils.servers import ThreadingHTTPServer, stop_serving

_ALGO = "AWS4-HMAC-SHA256"
_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


class S3SignatureError(Exception):
    pass


def _uri_encode(s: str, encode_slash: bool = True) -> str:
    """AWS URI encoding: unreserved chars pass; space -> %20 (never +)."""
    safe = "-_.~" if encode_slash else "-_.~/"
    return urllib.parse.quote(s, safe=safe)


def _canonical_query(query: str) -> str:
    if not query:
        return ""
    pairs = []
    for part in query.split("&"):
        if not part:
            continue
        k, _, v = part.partition("=")
        pairs.append((_uri_encode(urllib.parse.unquote(k)),
                      _uri_encode(urllib.parse.unquote(v))))
    return "&".join(f"{k}={v}" for k, v in sorted(pairs))


def sign_v4(method: str, url: str, headers: Dict[str, str],
            payload_hash: str, access_key: str, secret_key: str,
            region: str, service: str = "s3",
            amz_date: Optional[str] = None) -> Dict[str, str]:
    """Compute the SigV4 ``Authorization`` header for a request.

    ``headers`` must already include ``host`` (and any ``x-amz-*``
    headers to sign); ``amz_date`` is ``YYYYMMDD'T'HHMMSS'Z'`` (defaults
    to now, and is added to the returned headers as ``x-amz-date``).
    Returns the headers dict extended with ``x-amz-date`` +
    ``Authorization``."""
    split = urllib.parse.urlsplit(url)
    if amz_date is None:
        amz_date = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%M%SZ")
    date = amz_date[:8]
    out = dict(headers)
    out.setdefault("x-amz-date", amz_date)

    canon_headers = {k.lower().strip(): " ".join(str(v).split())
                     for k, v in out.items()}
    signed = ";".join(sorted(canon_headers))
    # canonical URI: S3 signs the path AS SENT (already once-encoded);
    # every other service URI-encodes each segment AGAIN (the documented
    # double-encoding rule) — getting this wrong is an interop-breaking
    # SignatureDoesNotMatch for any key with reserved characters
    path = split.path or "/"
    canon_uri = path if service == "s3" \
        else _uri_encode(path, encode_slash=False)
    canonical = "\n".join([
        method.upper(),
        canon_uri,
        _canonical_query(split.query),
        "".join(f"{k}:{canon_headers[k]}\n" for k in sorted(canon_headers)),
        signed,
        payload_hash,
    ])
    scope = f"{date}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        _ALGO, amz_date, scope,
        hashlib.sha256(canonical.encode()).hexdigest()])

    def _hmac(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k_date = _hmac(("AWS4" + secret_key).encode(), date)
    k_region = _hmac(k_date, region)
    k_service = _hmac(k_region, service)
    k_signing = _hmac(k_service, "aws4_request")
    signature = hmac.new(k_signing, string_to_sign.encode(),
                         hashlib.sha256).hexdigest()
    out["Authorization"] = (
        f"{_ALGO} Credential={access_key}/{scope}, "
        f"SignedHeaders={signed}, Signature={signature}")
    return out


class S3Client:
    """Minimal real-protocol S3 client (path-style addressing)."""

    def __init__(self, endpoint: str, bucket: str, access_key: str,
                 secret_key: str, region: str = "us-east-1",
                 timeout_s: float = 30.0):
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.timeout_s = timeout_s
        self._host = urllib.parse.urlsplit(self.endpoint).netloc

    def _request(self, method: str, key: str = "", query: str = "",
                 body: bytes = b""):
        path = "/" + self.bucket + (("/" + _uri_encode(key, False))
                                    if key else "")
        url = self.endpoint + path + (f"?{query}" if query else "")
        payload_hash = hashlib.sha256(body).hexdigest()
        headers = sign_v4(method, url,
                          {"host": self._host,
                           "x-amz-content-sha256": payload_hash},
                          payload_hash, self.access_key, self.secret_key,
                          self.region)
        req = urllib.request.Request(url, data=body if body else None,
                                     method=method, headers=headers)
        return urllib.request.urlopen(req, timeout=self.timeout_s)

    def put_object(self, key: str, data: bytes) -> None:
        self._request("PUT", key, body=data).read()

    def get_object(self, key: str) -> bytes:
        with self._request("GET", key) as r:
            return r.read()

    def delete_object(self, key: str) -> None:
        self._request("DELETE", key).read()

    def list_objects(self, prefix: str = "") -> List[Dict[str, object]]:
        """ListObjectsV2 (single page up to 1000 keys; the dialect's
        continuation-token pagination)."""
        import xml.etree.ElementTree as ET

        out: List[Dict[str, object]] = []
        token = None
        while True:
            q = "list-type=2&prefix=" + _uri_encode(prefix)
            if token:
                q += "&continuation-token=" + _uri_encode(token)
            with self._request("GET", "", query=q) as r:
                root = ET.fromstring(r.read())
            ns = root.tag.split("}")[0] + "}" if root.tag.startswith("{") \
                else ""
            for c in root.findall(f"{ns}Contents"):
                out.append({"key": c.findtext(f"{ns}Key"),
                            "size": int(c.findtext(f"{ns}Size") or 0),
                            "etag": (c.findtext(f"{ns}ETag")
                                     or "").strip('"')})
            if (root.findtext(f"{ns}IsTruncated") or "false") != "true":
                return out
            token = root.findtext(f"{ns}NextContinuationToken")

    def list_keys(self, prefix: str = "") -> List[str]:
        return [str(o["key"]) for o in self.list_objects(prefix)]

    # object-store client protocol (put/get/list/delete): lets the generic
    # checkpoint storage run unchanged over the S3 dialect
    def put(self, key: str, data: bytes) -> None:
        self.put_object(key, data)

    def get(self, key: str) -> bytes:
        return self.get_object(key)

    def list(self, prefix: str = "") -> List[str]:
        return self.list_keys(prefix)

    def delete(self, key: str) -> None:
        self.delete_object(key)


class S3CompatibleServer:
    """S3 REST dialect over a local directory (path-style, SigV4-verified).

    Anything speaking real S3 (the AWS CLI with a custom endpoint, MinIO
    clients, boto3, this module's client) can point at it — the
    capability-parity claim of ``flink-s3-fs-base`` in reverse."""

    MAX_KEYS = 1000
    #: accepted request age (SigV4's 15-minute window)
    SKEW_S = 900

    def __init__(self, directory: str, access_key: str, secret_key: str,
                 region: str = "us-east-1", host: str = "127.0.0.1",
                 port: int = 0, require_auth: bool = True):
        self.directory = directory
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.require_auth = require_auth
        os.makedirs(directory, exist_ok=True)
        self._put_lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            # -- plumbing --------------------------------------------------
            def _bucket_key(self) -> Optional[Tuple[str, str]]:
                """(bucket, key), or None after rejecting traversal names —
                ``quote(..., safe="")`` collapses keys to one path segment,
                so only literal "."/".." could escape the served dir."""
                path = urllib.parse.urlsplit(self.path).path
                parts = path.lstrip("/").split("/", 1)
                bucket = urllib.parse.unquote(parts[0])
                key = urllib.parse.unquote(parts[1]) if len(parts) > 1 else ""
                if bucket in ("", ".", "..") or key in (".", ".."):
                    self._error(400, "InvalidBucketName",
                                "bucket/key must not be a dot segment")
                    return None
                return bucket, key

            def _obj_path(self, bucket: str, key: str) -> str:
                safe = urllib.parse.quote(key, safe="")
                return os.path.join(server.directory,
                                    urllib.parse.quote(bucket, safe=""),
                                    safe)

            def _error(self, code: int, s3_code: str, msg: str) -> None:
                body = (f'<?xml version="1.0" encoding="UTF-8"?>'
                        f"<Error><Code>{_xml_escape(s3_code)}</Code>"
                        f"<Message>{_xml_escape(msg)}</Message>"
                        f"</Error>").encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/xml")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _ok(self, body: bytes = b"",
                    ctype: str = "application/xml") -> None:
                self.send_response(200)
                if body:
                    self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if body:
                    self.wfile.write(body)

            def _verify(self, body: bytes) -> bool:
                if not server.require_auth:
                    return True
                auth = self.headers.get("Authorization", "")
                amz_date = self.headers.get("x-amz-date", "")
                content_sha = self.headers.get("x-amz-content-sha256", "")
                if not auth.startswith(_ALGO) or not amz_date:
                    self._error(403, "AccessDenied", "missing SigV4 auth")
                    return False
                try:
                    fields = dict(
                        f.strip().split("=", 1)
                        for f in auth[len(_ALGO):].strip().split(","))
                    cred = fields["Credential"].split("/")
                    signed_headers = fields["SignedHeaders"].split(";")
                    their_sig = fields["Signature"].strip()
                except (KeyError, ValueError):
                    self._error(403, "AuthorizationHeaderMalformed",
                                "cannot parse Authorization")
                    return False
                if len(cred) != 5 or cred[4] != "aws4_request":
                    self._error(403, "AuthorizationHeaderMalformed",
                                "credential scope must be key/date/region/"
                                "service/aws4_request")
                    return False
                if cred[0] != server.access_key:
                    self._error(403, "InvalidAccessKeyId", cred[0])
                    return False
                # clock-skew window (replay resistance)
                try:
                    then = datetime.datetime.strptime(
                        amz_date, "%Y%m%dT%H%M%SZ").replace(
                            tzinfo=datetime.timezone.utc)
                except ValueError:
                    self._error(403, "AccessDenied", "bad x-amz-date")
                    return False
                now = datetime.datetime.now(datetime.timezone.utc)
                if abs((now - then).total_seconds()) > server.SKEW_S:
                    self._error(403, "RequestTimeTooSkewed", amz_date)
                    return False
                # the payload hash is SIGNED; verify it matches the body
                if content_sha and content_sha != "UNSIGNED-PAYLOAD":
                    if hashlib.sha256(body).hexdigest() != content_sha:
                        self._error(400, "XAmzContentSHA256Mismatch",
                                    "payload hash mismatch")
                        return False
                # reconstruct the canonical request from the SIGNED headers
                hdrs = {h: self.headers.get(h, "") for h in signed_headers}
                url = f"http://{self.headers.get('host', '')}{self.path}"
                expect = sign_v4(
                    self.command, url, hdrs,
                    content_sha or _EMPTY_SHA256,
                    server.access_key, server.secret_key,
                    cred[2], cred[3], amz_date=amz_date)
                ours = expect["Authorization"].rsplit("Signature=", 1)[1]
                if not hmac.compare_digest(ours, their_sig):
                    self._error(403, "SignatureDoesNotMatch",
                                "signature mismatch")
                    return False
                return True

            # -- verbs -----------------------------------------------------
            def do_PUT(self):
                ln = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(ln)
                if not self._verify(body):
                    return
                bk = self._bucket_key()
                if bk is None:
                    return
                bucket, key = bk
                if not key:
                    # CreateBucket
                    os.makedirs(os.path.join(
                        server.directory,
                        urllib.parse.quote(bucket, safe="")), exist_ok=True)
                    return self._ok()
                path = self._obj_path(bucket, key)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                # '#' never occurs in quote(safe="") output, so these
                # sidecar names can never collide with a stored object; the
                # temp suffix is per-request unique (concurrent PUTs of one
                # key must not interleave through a shared temp file)
                import uuid as _uuid
                tmp = f"{path}#tmp{_uuid.uuid4().hex[:8]}"
                with open(tmp, "wb") as f:
                    f.write(body)
                    f.flush()
                    os.fsync(f.fileno())
                etag = hashlib.md5(body).hexdigest()
                with open(tmp + "e", "w") as f:
                    f.write(etag)
                # finalize object+sidecar as one step under the server
                # lock: racing same-key PUTs must not install one writer's
                # object with the other's ETag
                with server._put_lock:
                    os.replace(tmp, path)
                    os.replace(tmp + "e", path + "#etag")
                self.send_response(200)
                self.send_header("ETag", f'"{etag}"')
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_GET(self):
                if not self._verify(b""):
                    return
                bk = self._bucket_key()
                if bk is None:
                    return
                bucket, key = bk
                query = urllib.parse.parse_qs(
                    urllib.parse.urlsplit(self.path).query)
                if not key:
                    return self._list(bucket, query)
                path = self._obj_path(bucket, key)
                if not os.path.exists(path):
                    return self._error(404, "NoSuchKey", key)
                with open(path, "rb") as f:
                    data = f.read()
                self._ok(data, ctype="application/octet-stream")

            def do_DELETE(self):
                if not self._verify(b""):
                    return
                bk = self._bucket_key()
                if bk is None:
                    return
                bucket, key = bk
                if not key:
                    # DeleteBucket: only when empty (the S3 contract)
                    bdir = os.path.join(server.directory,
                                        urllib.parse.quote(bucket, safe=""))
                    try:
                        os.rmdir(bdir)
                    except FileNotFoundError:
                        pass
                    except OSError:
                        return self._error(409, "BucketNotEmpty", bucket)
                else:
                    path = self._obj_path(bucket, key)
                    try:
                        os.remove(path)
                    except FileNotFoundError:
                        pass            # idempotent delete (S3 semantics)
                    except OSError as e:
                        return self._error(500, "InternalError", str(e))
                    try:
                        os.remove(path + "#etag")
                    except OSError:
                        pass
                self.send_response(204)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_HEAD(self):
                if not self._verify(b""):
                    return
                bk = self._bucket_key()
                if bk is None:
                    return
                bucket, key = bk
                path = self._obj_path(bucket, key)
                if not os.path.exists(path):
                    self.send_response(404)
                else:
                    self.send_response(200)
                    self.send_header("Content-Length",
                                     str(os.path.getsize(path)))
                self.end_headers()

            def _list(self, bucket: str, query) -> None:
                if query.get("list-type", [""])[0] != "2":
                    return self._error(400, "InvalidArgument",
                                       "only list-type=2 supported")
                prefix = query.get("prefix", [""])[0]
                start = query.get("continuation-token", [""])[0]
                bdir = os.path.join(server.directory,
                                    urllib.parse.quote(bucket, safe=""))
                keys: List[str] = []
                if os.path.isdir(bdir):
                    keys = sorted(
                        urllib.parse.unquote(n) for n in os.listdir(bdir)
                        if "#" not in n)     # sidecars/temps never list
                keys = [k for k in keys if k.startswith(prefix)
                        and (not start or k > start)]
                page = keys[:server.MAX_KEYS]
                truncated = len(keys) > len(page)
                items = []
                for k in page:
                    p = os.path.join(bdir, urllib.parse.quote(k, safe=""))
                    try:
                        size = os.path.getsize(p)
                        try:  # ETag stored at PUT time (no O(data) reads)
                            if os.path.getmtime(p + "#etag") \
                                    < os.path.getmtime(p):
                                raise OSError("stale sidecar")  # crash gap
                            with open(p + "#etag") as f:
                                etag = f.read().strip()
                        except OSError:
                            with open(p, "rb") as f:
                                etag = hashlib.md5(f.read()).hexdigest()
                    except OSError:
                        continue        # deleted concurrently: skip entry
                    items.append(
                        f"<Contents><Key>{_xml_escape(k)}</Key>"
                        f"<Size>{size}</Size>"
                        f"<ETag>&quot;{etag}&quot;</ETag>"
                        f"<StorageClass>STANDARD</StorageClass></Contents>")
                nxt = (f"<NextContinuationToken>{_xml_escape(page[-1])}"
                       f"</NextContinuationToken>") if truncated else ""
                body = (
                    '<?xml version="1.0" encoding="UTF-8"?>'
                    '<ListBucketResult '
                    'xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
                    f"<Name>{_xml_escape(bucket)}</Name>"
                    f"<Prefix>{_xml_escape(prefix)}</Prefix>"
                    f"<KeyCount>{len(page)}</KeyCount>"
                    f"<MaxKeys>{server.MAX_KEYS}</MaxKeys>"
                    f"<IsTruncated>{'true' if truncated else 'false'}"
                    f"</IsTruncated>{nxt}{''.join(items)}"
                    "</ListBucketResult>").encode()
                self._ok(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self.url = f"http://{self.host}:{self.port}"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="s3-server", daemon=True)

    def start(self) -> "S3CompatibleServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        stop_serving(self._httpd, self._thread)

    def serve_forever(self) -> None:
        """Foreground serving (CLI) — do NOT combine with start()."""
        self._httpd.serve_forever()

    def client(self, bucket: str) -> S3Client:
        return S3Client(self.url, bucket, self.access_key, self.secret_key,
                        self.region)


def _xml_escape(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))


class S3CheckpointStorage(ObjectStoreCheckpointStorage):
    """Checkpoint storage over the S3 dialect — the SAME key layout,
    versioned metadata-last protocol and device->host conversion as
    ``ObjectStoreCheckpointStorage`` (it IS that class, parameterized by
    an S3 client), so a job can checkpoint straight into any
    S3-compatible bucket and savepoint tooling reads it unchanged."""

    def __init__(self, endpoint: str, bucket: str, access_key: str,
                 secret_key: str, region: str = "us-east-1",
                 prefix: str = "", retain: int = 3):
        super().__init__(url="", prefix=prefix, retain=retain,
                         client=S3Client(endpoint, bucket, access_key,
                                         secret_key, region))

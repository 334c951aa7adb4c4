"""Schema registry + Confluent Avro wire format.

The port's copy of ``flink_tpu/formats/registry.py``: host Python as JAX's,
the same bytes on the wire and on disk, so either package's serializer
talks to the other's registry.

Analog of ``flink-formats/flink-avro-confluent-registry``
(``ConfluentRegistryAvroDeserializationSchema`` /
``RegistryAvroSerializationSchema``): Kafka record values frame as
``magic 0x00 | int32 schema id (big endian) | Avro binary datum``, with
schemas registered in and fetched from a registry service.

``SchemaRegistryServer`` speaks the Confluent REST surface the
serializers need — ``POST /subjects/{s}/versions`` (deduplicating
identical schemas, enforcing BACKWARD compatibility),
``GET /schemas/ids/{id}``, ``GET /subjects/{s}/versions/latest``,
``GET /subjects`` — and ``AvroRegistrySerializer`` plugs into the Kafka
connector's ``value_encoder``/``value_decoder`` seams, so evolving
producers and old consumers interoperate through the registry the same
way the reference's schemas do.
"""

from __future__ import annotations

import io
import json
import struct
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, List, Optional, Tuple

from flink_tpu_torch.formats.avro import (_decode_value, _encode_value,
                                          _field_type)
from flink_tpu_torch.utils.servers import ThreadingHTTPServer, stop_serving

MAGIC = 0


class SchemaRegistryError(Exception):
    pass


def _fields_of(schema: dict) -> List[Tuple[str, str, bool]]:
    return [(f["name"], *_field_type(f["type"]))
            for f in schema.get("fields", [])]


def _is_backward_compatible(new: dict, old: dict) -> Optional[str]:
    """BACKWARD: data written with ``old`` must be readable with ``new``.
    For the scalar-record subset: every old field must survive with the
    same base type (a non-null branch may widen to nullable), and fields
    NEW adds must be nullable (there is no default machinery here).
    Returns None when compatible, else the reason."""
    old_f = {n: (b, nul) for n, b, nul in _fields_of(old)}
    new_f = {n: (b, nul) for n, b, nul in _fields_of(new)}
    for name, (base, nullable) in old_f.items():
        got = new_f.get(name)
        if got is None:
            return f"field {name!r} removed"
        if got[0] != base:
            return (f"field {name!r} changed type "
                    f"{base} -> {got[0]}")
        if nullable and not got[1]:
            return f"field {name!r} narrowed from nullable"
    for name, (_base, nullable) in new_f.items():
        if name not in old_f and not nullable:
            return f"new field {name!r} must be nullable"
    return None


class SchemaRegistryServer:
    """Single-node Confluent-REST-shaped registry: global schema ids,
    per-subject version lists, BACKWARD compatibility on register."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._lock = threading.Lock()
        self._by_id: Dict[int, str] = {}          # id -> schema json text
        self._ids: Dict[str, int] = {}            # canonical text -> id
        self._subjects: Dict[str, List[int]] = {}  # subject -> version ids
        self._next = 1
        srv = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _reply(self, code: int, body: dict) -> None:
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type",
                                 "application/vnd.schemaregistry.v1+json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802
                # compute the response UNDER the lock, write it outside:
                # a stalled client socket must never block the registry
                parts = self.path.strip("/").split("/")
                code, body = 404, {"error_code": 404,
                                   "message": "not found"}
                with srv._lock:
                    if parts == ["subjects"]:
                        code, body = 200, sorted(srv._subjects)
                    elif (len(parts) == 3 and parts[0] == "schemas"
                            and parts[1] == "ids"):
                        text = srv._by_id.get(int(parts[2]))
                        if text is None:
                            code, body = 404, {
                                "error_code": 40403,
                                "message": "Schema not found"}
                        else:
                            code, body = 200, {"schema": text}
                    elif (len(parts) == 4 and parts[0] == "subjects"
                            and parts[2] == "versions"
                            and parts[3] == "latest"):
                        vers = srv._subjects.get(parts[1])
                        if not vers:
                            code, body = 404, {
                                "error_code": 40401,
                                "message": "Subject not found"}
                        else:
                            sid = vers[-1]
                            code, body = 200, {
                                "subject": parts[1], "version": len(vers),
                                "id": sid, "schema": srv._by_id[sid]}
                self._reply(code, body)

            def do_POST(self):  # noqa: N802
                parts = self.path.strip("/").split("/")
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n) or b"{}")
                if not (len(parts) == 3 and parts[0] == "subjects"
                        and parts[2] == "versions"):
                    return self._reply(404, {"error_code": 404,
                                             "message": "not found"})
                subject = parts[1]
                try:
                    schema = json.loads(body["schema"])
                except (KeyError, ValueError):
                    return self._reply(422, {
                        "error_code": 42201,
                        "message": "Invalid schema"})
                canon = json.dumps(schema, sort_keys=True,
                                   separators=(",", ":"))
                code, resp = 200, {}
                with srv._lock:
                    vers = srv._subjects.setdefault(subject, [])
                    why = None
                    if vers:
                        latest = json.loads(srv._by_id[vers[-1]])
                        why = _is_backward_compatible(schema, latest)
                    if why is not None:
                        code, resp = 409, {
                            "error_code": 409,
                            "message": f"Schema being registered is "
                                       f"incompatible: {why}"}
                    else:
                        sid = srv._ids.get(canon)
                        if sid is None:
                            sid = srv._next
                            srv._next += 1
                            srv._ids[canon] = sid
                            srv._by_id[sid] = canon
                        if sid not in vers:
                            vers.append(sid)
                        resp = {"id": sid}
                return self._reply(code, resp)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self.url = f"http://{self.host}:{self.port}"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        stop_serving(self._httpd, self._thread)


class SchemaRegistryClient:
    """REST client with id- and text-level caches (the serializers call
    per record; only NEW schemas hit the wire)."""

    def __init__(self, url: str, timeout_s: float = 10.0):
        self.url = url.rstrip("/")
        self.timeout_s = timeout_s
        self._by_id: Dict[int, dict] = {}
        self._ids: Dict[str, int] = {}

    def _call(self, method: str, path: str,
              body: Optional[dict] = None) -> Any:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(self.url + path, data=data,
                                     method=method)
        if data is not None:
            req.add_header("Content-Type",
                           "application/vnd.schemaregistry.v1+json")
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                err = json.loads(e.read() or b"{}")
            except ValueError:
                err = {}
            raise SchemaRegistryError(
                err.get("message", f"HTTP {e.code}")) from e
        except urllib.error.URLError as e:
            raise SchemaRegistryError(str(e.reason)) from e

    def register(self, subject: str, schema: dict) -> int:
        canon = json.dumps(schema, sort_keys=True, separators=(",", ":"))
        sid = self._ids.get(canon)
        if sid is None:
            sid = self._call("POST", f"/subjects/{subject}/versions",
                             {"schema": canon})["id"]
            self._ids[canon] = sid
            self._by_id[sid] = schema
        return sid

    def get_by_id(self, schema_id: int) -> dict:
        schema = self._by_id.get(schema_id)
        if schema is None:
            text = self._call("GET", f"/schemas/ids/{schema_id}")["schema"]
            schema = json.loads(text)
            self._by_id[schema_id] = schema
        return schema

    def latest(self, subject: str) -> Tuple[int, dict]:
        res = self._call("GET", f"/subjects/{subject}/versions/latest")
        return res["id"], json.loads(res["schema"])

    def subjects(self) -> List[str]:
        return self._call("GET", "/subjects")


class AvroRegistrySerializer:
    """Confluent wire format over the registry: rows encode as
    ``0x00 | schema id | Avro datum`` against a registered schema;
    decode reads ANY schema id (old producers keep working — the decoded
    row has that WRITER's fields, the consumer-side projection decides
    what to use)."""

    def __init__(self, registry_url: str, subject: str,
                 schema: Optional[dict] = None):
        self.client = SchemaRegistryClient(registry_url)
        self.subject = subject
        self._schema = schema
        self._schema_id: Optional[int] = None

    def _writer_schema(self, row: dict) -> Tuple[int, dict]:
        if self._schema is None:
            from flink_tpu_torch.formats.avro import schema_for_columns
            import numpy as np
            if any(v is None for v in row.values()):
                # None gives no type to infer — guessing nullable-string
                # would silently stringify later numeric values
                raise SchemaRegistryError(
                    "cannot infer a schema from a row with null values; "
                    "pass an explicit schema= with ['null', <type>] "
                    "unions")
            self._schema = schema_for_columns(
                {k: np.asarray([v]) for k, v in row.items()},
                name=self.subject)
        if self._schema_id is None:
            self._schema_id = self.client.register(self.subject,
                                                   self._schema)
        return self._schema_id, self._schema

    def encode(self, row: dict) -> bytes:
        sid, schema = self._writer_schema(row)
        buf = io.BytesIO()
        buf.write(struct.pack(">bI", MAGIC, sid))
        for name, base, nullable in _fields_of(schema):
            _encode_value(buf, base, nullable, row.get(name))
        return buf.getvalue()

    def decode(self, payload: bytes) -> dict:
        if len(payload) < 5 or payload[0] != MAGIC:
            raise SchemaRegistryError(
                f"not Confluent wire format "
                f"(magic/len {payload[:5]!r})")
        (sid,) = struct.unpack_from(">I", payload, 1)
        schema = self.client.get_by_id(sid)
        buf = io.BytesIO(payload[5:])
        return {name: _decode_value(buf, base, nullable)
                for name, base, nullable in _fields_of(schema)}

    # Kafka connector seams
    def decoder(self):
        """``KafkaWireSource(value_decoder=...)`` hook."""
        return lambda value: [self.decode(value)]

    def encoder(self):
        """``KafkaWireSink(value_encoder=...)`` hook."""
        return self.encode

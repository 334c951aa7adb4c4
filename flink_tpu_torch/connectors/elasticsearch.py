"""Elasticsearch connector: REST/JSON wire server, client, and sink.

The port's copy of ``flink_tpu/connectors/elasticsearch.py``: host Python
as JAX's, the same bytes on the wire and on disk, so either package's
client talks to the other's server.

Analog of ``flink-connectors/flink-connector-elasticsearch7``
(``ElasticsearchSink.java:63`` + ``BulkProcessor`` flushing): the sink
buffers index actions and flushes them as ``_bulk`` NDJSON requests —
at-least-once via flush-on-checkpoint, upgraded to effectively-once when a
deterministic ``id_column`` makes every retry an idempotent upsert (the
reference documents the same recipe).

Like the Kafka/Postgres connectors, the wire dialect is implemented from
the public HTTP API on BOTH sides: ``ElasticsearchServer`` is a minimal
single-node server (document CRUD, ``_bulk``, ``_search`` with match_all /
term queries, ``_count``) that real HTTP clients can talk to, and
``ElasticsearchClient`` is the urllib-based client the sink uses.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, List, Optional

import numpy as np

from flink_tpu_torch.utils.servers import ThreadingHTTPServer, stop_serving


class ElasticsearchServer:
    """Minimal single-node ES: indices of ``_id -> _source`` documents."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._lock = threading.Lock()
        #: index -> {_id: source dict}
        self.indices: Dict[str, Dict[str, dict]] = {}
        srv_self = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # silence request logging
                pass

            def _reply(self, code: int, body: dict) -> None:
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _body(self) -> bytes:
                n = int(self.headers.get("Content-Length") or 0)
                return self.rfile.read(n) if n else b""

            def do_PUT(self):  # noqa: N802 — create index
                parts = self.path.strip("/").split("/")
                if len(parts) == 1 and parts[0]:
                    created = srv_self._create_index(parts[0])
                    self._reply(200, {"acknowledged": True,
                                      "index": parts[0],
                                      "created": created})
                elif len(parts) == 3 and parts[1] == "_doc":
                    doc = json.loads(self._body() or b"{}")
                    srv_self._put_doc(parts[0], parts[2], doc)
                    self._reply(200, {"_index": parts[0], "_id": parts[2],
                                      "result": "created"})
                else:
                    self._reply(400, {"error": "bad PUT path"})

            def do_DELETE(self):  # noqa: N802
                parts = self.path.strip("/").split("/")
                with srv_self._lock:
                    if len(parts) == 1 and parts[0] in srv_self.indices:
                        del srv_self.indices[parts[0]]
                        self._reply(200, {"acknowledged": True})
                    elif len(parts) == 3 and parts[1] == "_doc":
                        idx = srv_self.indices.get(parts[0], {})
                        existed = idx.pop(parts[2], None) is not None
                        self._reply(200 if existed else 404,
                                    {"result": "deleted" if existed
                                     else "not_found"})
                    else:
                        self._reply(404, {"error": "not found"})

            def do_GET(self):  # noqa: N802
                path = urllib.parse.urlparse(self.path)
                parts = path.path.strip("/").split("/")
                if len(parts) == 3 and parts[1] == "_doc":
                    with srv_self._lock:
                        doc = srv_self.indices.get(parts[0], {}) \
                            .get(parts[2])
                    if doc is None:
                        self._reply(404, {"found": False})
                    else:
                        self._reply(200, {"_index": parts[0],
                                          "_id": parts[2],
                                          "found": True, "_source": doc})
                elif len(parts) == 2 and parts[1] == "_count":
                    with srv_self._lock:
                        n = len(srv_self.indices.get(parts[0], {}))
                    self._reply(200, {"count": n})
                elif len(parts) == 2 and parts[1] == "_search":
                    self._search(parts[0], {})
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):  # noqa: N802
                path = urllib.parse.urlparse(self.path)
                parts = path.path.strip("/").split("/")
                if parts == ["_bulk"] or (len(parts) == 2
                                          and parts[1] == "_bulk"):
                    default_index = parts[0] if len(parts) == 2 else None
                    self._bulk(default_index)
                elif len(parts) == 2 and parts[1] == "_search":
                    self._search(parts[0],
                                 json.loads(self._body() or b"{}"))
                elif len(parts) == 2 and parts[1] == "_doc":
                    doc = json.loads(self._body() or b"{}")
                    did = uuid.uuid4().hex
                    srv_self._put_doc(parts[0], did, doc)
                    self._reply(201, {"_index": parts[0], "_id": did,
                                      "result": "created"})
                else:
                    self._reply(404, {"error": "not found"})

            def _bulk(self, default_index: Optional[str]) -> None:
                lines = [ln for ln in self._body().split(b"\n") if ln]
                items: List[dict] = []
                errors = False
                i = 0
                while i < len(lines):
                    try:
                        action = json.loads(lines[i])
                    except ValueError:
                        self._reply(400, {"error": "malformed action line"})
                        return
                    op = next(iter(action))
                    if op not in ("index", "create", "update", "delete"):
                        # reject like real ES: an unknown op consuming the
                        # wrong number of lines would desync the whole
                        # action/source framing after it
                        self._reply(400, {"error":
                                          f"unknown bulk action {op!r}"})
                        return
                    meta = action[op] or {}
                    index = meta.get("_index", default_index)
                    did = meta.get("_id") or uuid.uuid4().hex
                    i += 1
                    if op in ("index", "create", "update"):
                        if i >= len(lines):
                            self._reply(400, {"error": "missing source"})
                            return
                        src = json.loads(lines[i])
                        i += 1
                        if op == "update":
                            src = src.get("doc", src)
                        status = srv_self._bulk_put(index, did, src, op)
                    else:           # delete
                        status = srv_self._bulk_delete(index, did)
                    errors |= status >= 400
                    items.append({op: {"_index": index, "_id": did,
                                       "status": status}})
                self._reply(200, {"errors": errors, "items": items})

            def _search(self, index: str, body: dict) -> None:
                size = int(body.get("size", 10))
                query = body.get("query", {"match_all": {}})
                with srv_self._lock:
                    docs = dict(srv_self.indices.get(index, {}))
                if "term" in query:
                    ((field, want),) = query["term"].items()
                    if isinstance(want, dict):
                        want = want.get("value")
                    docs = {k: v for k, v in docs.items()
                            if v.get(field) == want}
                hits = [{"_index": index, "_id": k, "_source": v}
                        for k, v in list(docs.items())[:size]]
                self._reply(200, {
                    "hits": {"total": {"value": len(docs)}, "hits": hits}})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def _create_index(self, name: str) -> bool:
        with self._lock:
            if name in self.indices:
                return False
            self.indices[name] = {}
            return True

    def _put_doc(self, index: str, did: str, doc: dict) -> None:
        with self._lock:
            self.indices.setdefault(index, {})[did] = doc

    def _bulk_put(self, index, did, src, op) -> int:
        if index is None:
            return 400
        with self._lock:
            idx = self.indices.setdefault(index, {})
            if op == "create" and did in idx:
                return 409           # version conflict, like real ES
            if op == "update" and did in idx:
                merged = dict(idx[did])
                merged.update(src)
                idx[did] = merged
            else:
                idx[did] = src
        return 200

    def _bulk_delete(self, index, did) -> int:
        if index is None:
            return 400
        with self._lock:
            existed = self.indices.get(index, {}).pop(did, None)
        return 200 if existed is not None else 404

    def close(self) -> None:
        stop_serving(self._httpd, self._thread)


class ElasticsearchError(Exception):
    pass


class ElasticsearchClient:
    """urllib REST client (the RestHighLevelClient analog the sink uses)."""

    def __init__(self, host: str, port: int, timeout_s: float = 10.0):
        self.base = f"http://{host}:{port}"
        self.timeout_s = timeout_s

    def _call(self, method: str, path: str,
              body: Optional[bytes] = None,
              content_type: str = "application/json") -> dict:
        req = urllib.request.Request(self.base + path, data=body,
                                     method=method)
        if body is not None:
            req.add_header("Content-Type", content_type)
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            raise ElasticsearchError(
                f"{method} {path}: {e.code} {e.read()[:200]!r}") from e
        except urllib.error.URLError as e:
            # connection-level failure (refused / timeout / DNS): callers
            # handle ElasticsearchError, never a raw URLError
            raise ElasticsearchError(f"{method} {path}: {e.reason}") from e

    def create_index(self, index: str) -> None:
        self._call("PUT", f"/{index}")

    def bulk(self, actions: List[dict]) -> dict:
        """actions: [{"op": "index"|"create"|"delete"|"update",
        "index": .., "id": .. or None, "doc": {..}}]; raises on any
        item-level error (the sink's failure handler surface)."""
        lines = []
        for a in actions:
            meta = {"_index": a["index"]}
            if a.get("id") is not None:
                meta["_id"] = str(a["id"])
            lines.append(json.dumps({a.get("op", "index"): meta}))
            if a.get("op", "index") != "delete":
                doc = a["doc"]
                lines.append(json.dumps(
                    {"doc": doc} if a.get("op") == "update" else doc))
        body = ("\n".join(lines) + "\n").encode()
        res = self._call("POST", "/_bulk", body,
                         "application/x-ndjson")
        if res.get("errors"):
            bad = [it for it in res["items"]
                   for op in it.values() if op["status"] >= 400]
            raise ElasticsearchError(f"bulk failures: {bad[:3]}")
        return res

    def get(self, index: str, did: str) -> Optional[dict]:
        try:
            return self._call("GET", f"/{index}/_doc/{did}")["_source"]
        except ElasticsearchError:
            return None

    def count(self, index: str) -> int:
        return int(self._call("GET", f"/{index}/_count")["count"])

    def search(self, index: str, query: Optional[dict] = None,
               size: int = 10) -> List[dict]:
        body = json.dumps({"query": query or {"match_all": {}},
                           "size": size}).encode()
        res = self._call("POST", f"/{index}/_search", body)
        return [h["_source"] for h in res["hits"]["hits"]]


def _json_value(v):
    if isinstance(v, np.generic):
        return v.item()
    return v


class ElasticsearchSink:
    """Bulk-flushing sink (``ElasticsearchSink.java:63`` +
    ``BulkProcessorBuilder`` flush knobs): rows buffer into index actions,
    flushing at ``bulk_actions`` and on EVERY checkpoint
    (flush-on-checkpoint = at-least-once).  With ``id_column`` set, the
    document id is deterministic and replayed writes overwrite themselves —
    the reference's documented idempotent-upsert recipe for
    effectively-once delivery."""

    clone_per_subtask = True

    def __init__(self, host: str, port: int, index: str,
                 id_column: Optional[str] = None,
                 bulk_actions: int = 1000):
        self.host, self.port = host, port
        self.index = index
        self.id_column = id_column
        self.bulk_actions = bulk_actions
        self._client: Optional[ElasticsearchClient] = None
        self._buf: List[dict] = []
        self.documents_written = 0

    def _cli(self) -> ElasticsearchClient:
        if self._client is None:
            self._client = ElasticsearchClient(self.host, self.port)
        return self._client

    def open(self, ctx) -> None:
        self._cli()

    def write_batch(self, batch) -> None:
        if not len(batch):
            return
        for r in batch.to_rows():
            doc = {k: _json_value(v) for k, v in r.items()}
            self._buf.append({
                "op": "index", "index": self.index,
                "id": doc.get(self.id_column)
                if self.id_column is not None else None,
                "doc": doc})
        if len(self._buf) >= self.bulk_actions:
            self._flush()

    def _flush(self) -> None:
        if not self._buf:
            return
        self._cli().bulk(self._buf)
        self.documents_written += len(self._buf)
        self._buf = []

    def snapshot_state(self) -> Dict[str, Any]:
        # flush-on-checkpoint: everything before the barrier is durable in
        # ES before the checkpoint completes (at-least-once contract)
        self._flush()
        return {}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self._buf = []

    def end_input(self) -> None:
        self._flush()

    def close(self) -> None:
        try:
            self._flush()
        except ElasticsearchError:
            pass
        self._client = None

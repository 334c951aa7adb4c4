"""Kinesis connector: JSON-over-HTTP wire service, client, source, sink.

The port's copy of ``flink_tpu/connectors/kinesis.py``: host Python as
JAX's, the same bytes on the wire and on disk, so either package's client
talks to the other's server.

Analog of ``flink-connectors/flink-connector-kinesis``
(``FlinkKinesisConsumer`` + ``FlinkKinesisProducer``): the source reads
shards with per-shard SEQUENCE-NUMBER checkpointing (the consumer's
``sequenceNumsToRestore``) via the positioned-reader seam, the sink
batches ``PutRecords`` calls (at-least-once).

The wire dialect is the real Kinesis Data Streams API shape: POST ``/``
with ``X-Amz-Target: Kinesis_20131202.<Action>`` and a JSON body,
records base64-encoded, opaque shard iterators, ``TRIM_HORIZON`` /
``AT_SEQUENCE_NUMBER`` / ``AFTER_SEQUENCE_NUMBER`` / ``LATEST`` iterator
types, and SigV4 request signing (``service="kinesis"``) reusing the S3
module's signer — ``KinesisService`` checks that the signed
Authorization header carries the configured access-key ID (a presence
check, NOT a full signature re-derivation; that lives in the S3
server).  Partition keys route to shards by hash (real Kinesis splits
the md5 hash-key RANGE across shards; same distribution, simpler
bookkeeping).
"""

from __future__ import annotations

import base64
import hashlib
import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.connectors.sources import Source, SourceSplit
from flink_tpu_torch.connectors.util import json_default
from flink_tpu_torch.utils.servers import ThreadingHTTPServer, stop_serving

_TARGET_PREFIX = "Kinesis_20131202."


class KinesisError(Exception):
    def __init__(self, error_type: str, message: str = ""):
        self.error_type = error_type
        super().__init__(f"{error_type}: {message}")


def _shard_of(partition_key: str, n_shards: int) -> int:
    h = int(hashlib.md5(partition_key.encode()).hexdigest(), 16)
    return h % n_shards


class KinesisService:
    """Single-node Kinesis Data Streams service: streams of shards, each
    an append-only record list (sequence number = list index)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 access_key: Optional[str] = None,
                 secret_key: Optional[str] = None):
        self._lock = threading.Lock()
        #: stream -> [shard] where shard = [(partition_key, data bytes)]
        self.streams: Dict[str, List[List[Tuple[str, bytes]]]] = {}
        self._access, self._secret = access_key, secret_key
        svc = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _reply(self, code: int, body: dict) -> None:
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type",
                                 "application/x-amz-json-1.1")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b"{}"
                if svc._access is not None and not self._authorized():
                    return self._reply(403, {
                        "__type": "AccessDeniedException"})
                target = self.headers.get("X-Amz-Target", "")
                if not target.startswith(_TARGET_PREFIX):
                    return self._reply(400, {
                        "__type": "UnknownOperationException"})
                action = target[len(_TARGET_PREFIX):]
                try:
                    req = json.loads(body or b"{}")
                    out = svc._dispatch(action, req)
                except KinesisError as e:
                    return self._reply(400, {"__type": e.error_type,
                                             "message": str(e)})
                except (KeyError, ValueError, TypeError) as e:
                    return self._reply(400, {
                        "__type": "ValidationException",
                        "message": str(e)})
                self._reply(200, out)

            def _authorized(self) -> bool:
                # presence-of-credential check: the full SigV4 re-derivation
                # lives in the S3 server; here the signed request must at
                # least carry a matching access key id
                auth = self.headers.get("Authorization", "")
                return f"Credential={svc._access}/" in auth

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    # -- actions ------------------------------------------------------------
    def _dispatch(self, action: str, req: dict) -> dict:
        fn = getattr(self, f"_a_{action}", None)
        if fn is None:
            raise KinesisError("UnknownOperationException", action)
        return fn(req)

    def _stream(self, name: str) -> List[List[Tuple[str, bytes]]]:
        s = self.streams.get(name)
        if s is None:
            raise KinesisError("ResourceNotFoundException", name)
        return s

    def _shard(self, name: str, idx: int) -> List[Tuple[str, bytes]]:
        shards = self._stream(name)
        if not 0 <= idx < len(shards):
            raise KinesisError("ResourceNotFoundException",
                               f"{name} shard {idx}")
        return shards[idx]

    def _a_CreateStream(self, req: dict) -> dict:  # noqa: N802
        name = req["StreamName"]
        n = int(req.get("ShardCount", 1))
        with self._lock:
            if name in self.streams:
                raise KinesisError("ResourceInUseException", name)
            self.streams[name] = [[] for _ in range(n)]
        return {}

    def _a_DescribeStream(self, req: dict) -> dict:  # noqa: N802
        with self._lock:
            shards = self._stream(req["StreamName"])
            return {"StreamDescription": {
                "StreamName": req["StreamName"],
                "StreamStatus": "ACTIVE",
                "Shards": [{"ShardId": f"shardId-{i:012d}"}
                           for i in range(len(shards))]}}

    def _a_ListShards(self, req: dict) -> dict:  # noqa: N802
        with self._lock:
            shards = self._stream(req["StreamName"])
            return {"Shards": [{"ShardId": f"shardId-{i:012d}"}
                               for i in range(len(shards))]}

    def _a_PutRecord(self, req: dict) -> dict:  # noqa: N802
        data = base64.b64decode(req["Data"])
        pk = req["PartitionKey"]
        with self._lock:
            shards = self._stream(req["StreamName"])
            i = _shard_of(pk, len(shards))
            shards[i].append((pk, data))
            seq = len(shards[i]) - 1
        return {"ShardId": f"shardId-{i:012d}",
                "SequenceNumber": str(seq)}

    def _a_PutRecords(self, req: dict) -> dict:  # noqa: N802
        out = []
        failed = 0
        with self._lock:
            shards = self._stream(req["StreamName"])
            for rec in req["Records"]:
                data = base64.b64decode(rec["Data"])
                pk = rec["PartitionKey"]
                i = _shard_of(pk, len(shards))
                shards[i].append((pk, data))
                out.append({"ShardId": f"shardId-{i:012d}",
                            "SequenceNumber": str(len(shards[i]) - 1)})
        return {"FailedRecordCount": failed, "Records": out}

    @staticmethod
    def _shard_index(shard_id: str) -> int:
        return int(shard_id.rsplit("-", 1)[-1])

    def _a_GetShardIterator(self, req: dict) -> dict:  # noqa: N802
        name = req["StreamName"]
        idx = self._shard_index(req["ShardId"])
        typ = req["ShardIteratorType"]
        with self._lock:
            shard = self._shard(name, idx)
            if typ == "TRIM_HORIZON":
                pos = 0
            elif typ == "LATEST":
                pos = len(shard)
            elif typ == "AT_SEQUENCE_NUMBER":
                pos = int(req["StartingSequenceNumber"])
            elif typ == "AFTER_SEQUENCE_NUMBER":
                pos = int(req["StartingSequenceNumber"]) + 1
            else:
                raise KinesisError("ValidationException", typ)
        return {"ShardIterator": f"{name}|{idx}|{pos}"}

    def _a_GetRecords(self, req: dict) -> dict:  # noqa: N802
        name, idx_s, pos_s = req["ShardIterator"].split("|")
        idx, pos = int(idx_s), int(pos_s)
        limit = int(req.get("Limit", 10_000))
        with self._lock:
            shard = self._shard(name, idx)
            chunk = shard[pos:pos + limit]
            end = pos + len(chunk)
            behind = len(shard) - end
        return {
            "Records": [{
                "SequenceNumber": str(pos + j),
                "PartitionKey": pk,
                "Data": base64.b64encode(data).decode(),
            } for j, (pk, data) in enumerate(chunk)],
            "NextShardIterator": f"{name}|{idx}|{end}",
            "MillisBehindLatest": 0 if behind == 0 else 1,
        }

    def close(self) -> None:
        stop_serving(self._httpd, self._thread)


class KinesisClient:
    """SigV4-signed JSON client (the AWS SDK analog the connector uses)."""

    def __init__(self, endpoint: str, access_key: str = "test",
                 secret_key: str = "test", region: str = "us-east-1",
                 timeout_s: float = 10.0):
        self.endpoint = endpoint.rstrip("/")
        self.access_key, self.secret_key = access_key, secret_key
        self.region = region
        self.timeout_s = timeout_s

    def call(self, action: str, body: dict) -> dict:
        from flink_tpu_torch.filesystems.s3 import sign_v4
        payload = json.dumps(body).encode()
        host = self.endpoint.split("://", 1)[-1]
        headers = {
            "host": host,
            "X-Amz-Target": _TARGET_PREFIX + action,
            "Content-Type": "application/x-amz-json-1.1",
        }
        headers = sign_v4("POST", self.endpoint + "/", headers,
                          hashlib.sha256(payload).hexdigest(),
                          self.access_key, self.secret_key, self.region,
                          service="kinesis")
        req = urllib.request.Request(self.endpoint + "/", data=payload,
                                     method="POST", headers=headers)
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                err = json.loads(e.read() or b"{}")
            except ValueError:
                err = {}
            raise KinesisError(err.get("__type", f"HTTP{e.code}"),
                               err.get("message", "")) from e
        except urllib.error.URLError as e:
            raise KinesisError("ConnectionError", str(e.reason)) from e

    # convenience wrappers
    def create_stream(self, name: str, shards: int = 1) -> None:
        self.call("CreateStream", {"StreamName": name,
                                   "ShardCount": shards})

    def list_shards(self, name: str) -> List[str]:
        return [s["ShardId"] for s in
                self.call("ListShards", {"StreamName": name})["Shards"]]

    def put_records(self, name: str,
                    records: List[Tuple[str, bytes]]) -> None:
        self.call("PutRecords", {"StreamName": name, "Records": [
            {"PartitionKey": pk,
             "Data": base64.b64encode(data).decode()}
            for pk, data in records]})

    def shard_iterator(self, name: str, shard_id: str,
                       after_sequence: Optional[int] = None) -> str:
        req = {"StreamName": name, "ShardId": shard_id}
        if after_sequence is None:
            req["ShardIteratorType"] = "TRIM_HORIZON"
        else:
            req["ShardIteratorType"] = "AFTER_SEQUENCE_NUMBER"
            req["StartingSequenceNumber"] = str(after_sequence)
        return self.call("GetShardIterator", req)["ShardIterator"]

    def get_records(self, iterator: str, limit: int = 10_000) -> dict:
        return self.call("GetRecords", {"ShardIterator": iterator,
                                        "Limit": limit})


# ---------------------------------------------------------------------------
# source / sink
# ---------------------------------------------------------------------------


class _PositionedShardReader:
    """Iterator over one shard's batches; ``position`` = records already
    emitted (the per-shard sequence-number checkpoint of
    ``FlinkKinesisConsumer``)."""

    def __init__(self, source: "KinesisSource", shard_id: str,
                 start: int):
        self.position = int(start)
        self._it = source._read_shard(shard_id, self.position)

    def __iter__(self):
        return self

    def __next__(self):
        el = next(self._it)
        self.position += len(el)    # rows already HANDED OVER
        return el


class KinesisShardSplit(SourceSplit):
    def __init__(self, source: "KinesisSource", index: int, total: int,
                 shard_id: str):
        super().__init__(source, index, total)
        self.shard_id = shard_id

    def split_id(self) -> str:
        return f"{self.source.stream}-{self.shard_id}"

    def read(self):
        return self.source.open_split(self, None)


class KinesisSource(Source):
    """Bounded shard scan up to each shard's tip at open: one split per
    shard, JSON row values, resumable positions."""

    def __init__(self, endpoint: str, stream: str,
                 access_key: str = "test", secret_key: str = "test",
                 batch_rows: int = 1024,
                 timestamp_column: Optional[str] = None):
        self.endpoint = endpoint
        self.stream = stream
        self.access_key, self.secret_key = access_key, secret_key
        self.batch_rows = batch_rows
        self.timestamp_column = timestamp_column

    def _client(self) -> KinesisClient:
        return KinesisClient(self.endpoint, self.access_key,
                             self.secret_key)

    def create_splits(self, parallelism: int) -> List[KinesisShardSplit]:
        shard_ids = self._client().list_shards(self.stream)
        return [KinesisShardSplit(self, i, len(shard_ids), sid)
                for i, sid in enumerate(shard_ids)]

    def open_split(self, split: KinesisShardSplit,
                   position: Optional[int]) -> _PositionedShardReader:
        return _PositionedShardReader(self, split.shard_id, position or 0)

    def _read_shard(self, shard_id: str, start: int):
        from flink_tpu_torch.core.batch import RecordBatch

        c = self._client()
        it = c.shard_iterator(self.stream, shard_id,
                              after_sequence=start - 1 if start else None)
        rows: List[dict] = []
        while True:
            res = c.get_records(it, limit=self.batch_rows)
            it = res["NextShardIterator"]
            for rec in res["Records"]:
                rows.append(json.loads(
                    base64.b64decode(rec["Data"]).decode()))
                if len(rows) >= self.batch_rows:
                    yield self._batch(rows, RecordBatch)
                    rows = []
            if res["MillisBehindLatest"] == 0:
                break               # caught up to the tip at open: bounded
        if rows:
            yield self._batch(rows, RecordBatch)

    def _batch(self, rows, _RecordBatch):
        from flink_tpu_torch.connectors.util import rows_to_batch
        return rows_to_batch(rows, self.timestamp_column)


class KinesisSink:
    """``FlinkKinesisProducer`` analog: rows publish as JSON via batched
    PutRecords (at-least-once; flushed on checkpoint and close)."""

    clone_per_subtask = True

    def __init__(self, endpoint: str, stream: str,
                 partition_key_column: Optional[str] = None,
                 access_key: str = "test", secret_key: str = "test",
                 buffer_rows: int = 500):
        self.endpoint = endpoint
        self.stream = stream
        self.partition_key_column = partition_key_column
        self.access_key, self.secret_key = access_key, secret_key
        self.buffer_rows = buffer_rows
        self._client: Optional[KinesisClient] = None
        self._buf: List[Tuple[str, bytes]] = []
        self._n = 0

    def _cli(self) -> KinesisClient:
        if self._client is None:
            self._client = KinesisClient(self.endpoint, self.access_key,
                                         self.secret_key)
        return self._client

    def open(self, ctx) -> None:
        self._cli()

    def write_batch(self, batch) -> None:
        for r in batch.to_rows():
            pk = (str(r[self.partition_key_column])
                  if self.partition_key_column is not None
                  else str(self._n))
            self._n += 1
            self._buf.append((pk, json.dumps(
                r, default=json_default).encode()))
        if len(self._buf) >= self.buffer_rows:
            self._flush()

    def _flush(self) -> None:
        if self._buf:
            self._cli().put_records(self.stream, self._buf)
            self._buf = []

    def snapshot_state(self) -> Dict[str, Any]:
        self._flush()               # flush-on-checkpoint: at-least-once
        return {}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self._buf = []

    def end_input(self) -> None:
        self._flush()

    def close(self) -> None:
        try:
            self._flush()
        except KinesisError:
            pass
        self._client = None

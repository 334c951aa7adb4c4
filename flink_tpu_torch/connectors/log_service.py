"""Log service: a standalone broker any process can talk to over HTTP.

The port's copy of ``flink_tpu/connectors/log_service.py``: host Python as
JAX's, the same bytes on the wire and on disk, so a topic either package
writes reads in the other.

The external-system connector (VERDICT r1 #8): the reference's flagship
connector is Kafka (``flink-connectors/flink-connector-kafka``:
``KafkaSource`` FLIP-27 + transactional ``KafkaSink``); no broker ships in
this environment, so this module provides the same shape as a real network
service — a **broker process** (``python -m flink_tpu_torch logservice``)
serving topics/partitions/offsets over HTTP, durable on disk via
:class:`~flink_tpu_torch.connectors.partitioned_log.PartitionedLog`, plus
client ``Source``/``Sink`` classes that speak the wire protocol from ANY
process.

Wire protocol (HTTP, bodies are CRC-framed FTB record batches):
  - ``POST /topics/{t}?partitions=N``                create topic
  - ``GET  /topics/{t}``                             -> meta JSON
  - ``POST /topics/{t}/{p}/append``                  append one batch;
        idempotent-producer headers ``X-Producer-Id``/``X-Seq`` dedupe
        retried appends (the Kafka idempotent-producer sequence protocol)
  - ``GET  /topics/{t}/{p}/fetch?offset=B&max_bytes=M``
        -> framed batches, ``X-Next-Offset`` header

Exactly-once sink: batches stage in the checkpoint (2PC,
``TwoPhaseCommitSinkFunction`` analog) and commit with producer sequences,
so a replayed commit after restore is deduplicated broker-side.
"""

from __future__ import annotations

import io
import json
import os
import threading
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.connectors.sources import Source, SourceSplit
from flink_tpu_torch.core.batch import RecordBatch, StreamElement, Watermark
from flink_tpu_torch.utils.servers import ThreadingHTTPServer, stop_serving


# --------------------------------------------------------------------------
# broker
# --------------------------------------------------------------------------

class LogServiceBroker:
    """Durable topic/partition/offset broker over HTTP (threaded)."""

    def __init__(self, directory: str, host: str = "127.0.0.1",
                 port: int = 0):
        from flink_tpu_torch.connectors.partitioned_log import PartitionedLog

        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._logs: Dict[str, PartitionedLog] = {}
        #: idempotent producers: (topic, part, producer) -> last seq
        self._seqs: Dict[Tuple[str, int, str], int] = {}
        self._lock = threading.Lock()
        self._seq_path = os.path.join(directory, "_producer_seqs.json")
        if os.path.exists(self._seq_path):
            with open(self._seq_path) as f:
                for k, v in json.load(f).items():
                    topic, part, producer = k.rsplit("|", 2)
                    self._seqs[(topic, int(part), producer)] = v
        for name in os.listdir(directory):
            d = os.path.join(directory, name)
            if os.path.isdir(d) and PartitionedLog.exists(d):
                self._logs[name] = PartitionedLog(d)
        broker = self
        errlog = open(os.devnull, "w")

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                errlog.write((fmt % args) + "\n")

            def _json(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                parts = [p for p in self.path.split("?")[0].split("/") if p]
                q = urllib.parse.parse_qs(
                    urllib.parse.urlsplit(self.path).query)
                try:
                    if len(parts) == 2 and parts[0] == "topics":
                        n = int(q.get("partitions", ["1"])[0])
                        broker.create_topic(parts[1], n)
                        return self._json(200, {"ok": True})
                    if len(parts) == 4 and parts[0] == "topics" \
                            and parts[3] == "append":
                        ln = int(self.headers["Content-Length"])
                        payload = self.rfile.read(ln)
                        end = broker.append(
                            parts[1], int(parts[2]), payload,
                            self.headers.get("X-Producer-Id"),
                            self.headers.get("X-Seq"))
                        return self._json(200, {"end_offset": end})
                    self._json(404, {"error": "not found"})
                except Exception as e:  # noqa: BLE001 — wire boundary
                    self._json(500, {"error": str(e)})

            def do_GET(self):
                parts = [p for p in self.path.split("?")[0].split("/") if p]
                q = urllib.parse.parse_qs(
                    urllib.parse.urlsplit(self.path).query)
                try:
                    if len(parts) == 2 and parts[0] == "topics":
                        return self._json(200, broker.meta(parts[1]))
                    if len(parts) == 4 and parts[0] == "topics" \
                            and parts[3] == "fetch":
                        off = int(q.get("offset", ["0"])[0])
                        mx = int(q.get("max_bytes", ["1048576"])[0])
                        data, nxt = broker.fetch(parts[1], int(parts[2]),
                                                 off, mx)
                        self.send_response(200)
                        self.send_header("Content-Length", str(len(data)))
                        self.send_header("X-Next-Offset", str(nxt))
                        self.end_headers()
                        self.wfile.write(data)
                        return
                    self._json(404, {"error": "not found"})
                except KeyError:
                    self._json(404, {"error": "unknown topic"})
                except Exception as e:  # noqa: BLE001
                    self._json(500, {"error": str(e)})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self.url = f"http://{self.host}:{self.port}"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="log-broker", daemon=True)

    def start(self) -> "LogServiceBroker":
        self._thread.start()
        return self

    def stop(self) -> None:
        stop_serving(self._httpd, self._thread)

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    # -- broker ops --------------------------------------------------------
    def create_topic(self, topic: str, partitions: int) -> None:
        from flink_tpu_torch.connectors.partitioned_log import PartitionedLog

        with self._lock:
            if topic not in self._logs:
                self._logs[topic] = PartitionedLog(
                    os.path.join(self.directory, topic), partitions)

    def meta(self, topic: str) -> Dict[str, Any]:
        log = self._logs[topic]
        return {"num_partitions": log.num_partitions,
                "end_offsets": [log.end_offset(p)
                                for p in range(log.num_partitions)]}

    def append(self, topic: str, partition: int, framed: bytes,
               producer: Optional[str], seq: Optional[str]) -> int:
        log = self._logs[topic]
        with self._lock:
            if producer is not None and seq is not None:
                key = (topic, partition, producer)
                if self._seqs.get(key, -1) >= int(seq):
                    return log.end_offset(partition)  # duplicate: dropped
            path = log._path(partition)
            with open(path, "ab") as f:
                f.write(framed)
                f.flush()
                os.fsync(f.fileno())
                end = f.tell()
            # sequence is recorded only AFTER the data is durable: a crash
            # between the two at worst re-admits the producer's retry of the
            # same batch (duplicate, the at-least-once floor) — never drops
            # an acknowledged-but-unwritten batch as a "duplicate"
            if producer is not None and seq is not None:
                self._seqs[(topic, partition, producer)] = int(seq)
                self._persist_seqs()
            return end

    def _persist_seqs(self) -> None:
        tmp = self._seq_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({f"{t}|{p}|{pr}": v
                       for (t, p, pr), v in self._seqs.items()}, f)
        os.replace(tmp, self._seq_path)

    def fetch(self, topic: str, partition: int, offset: int,
              max_bytes: int) -> Tuple[bytes, int]:
        log = self._logs[topic]
        path = log._path(partition)
        end = log.end_offset(partition)
        if offset >= end:
            return b"", offset
        take = min(max_bytes, end - offset)
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(take)
        # truncate to whole frames (a fetch never splits a record batch)
        from flink_tpu_torch.formats import frame_span
        whole = frame_span(data)
        return data[:whole], offset + whole


# --------------------------------------------------------------------------
# client
# --------------------------------------------------------------------------

class LogServiceClient:
    """Thin wire-protocol client (usable from any process/language that can
    speak HTTP — this is the boundary an external system integrates at)."""

    def __init__(self, url: str, timeout_s: float = 30.0):
        self.url = url.rstrip("/")
        self.timeout_s = timeout_s

    def _req(self, method: str, path: str, body: Optional[bytes] = None,
             headers: Optional[Dict[str, str]] = None):
        req = urllib.request.Request(self.url + path, data=body,
                                     method=method,
                                     headers=headers or {})
        return urllib.request.urlopen(req, timeout=self.timeout_s)

    def create_topic(self, topic: str, partitions: int = 1) -> None:
        self._req("POST", f"/topics/{topic}?partitions={partitions}").read()

    def meta(self, topic: str) -> Dict[str, Any]:
        with self._req("GET", f"/topics/{topic}") as r:
            return json.loads(r.read())

    def append(self, topic: str, partition: int, batch: RecordBatch,
               producer: Optional[str] = None,
               seq: Optional[int] = None) -> int:
        from flink_tpu_torch.formats import write_frame
        from flink_tpu_torch.native.codec import encode_batch

        buf = io.BytesIO()
        write_frame(buf, encode_batch(batch))
        headers = {}
        if producer is not None:
            headers["X-Producer-Id"] = producer
            headers["X-Seq"] = str(seq)
        with self._req("POST", f"/topics/{topic}/{partition}/append",
                       buf.getvalue(), headers) as r:
            return json.loads(r.read())["end_offset"]

    def fetch(self, topic: str, partition: int, offset: int,
              max_bytes: int = 1 << 20) -> Tuple[List[RecordBatch], int]:
        from flink_tpu_torch.formats import iter_frames
        from flink_tpu_torch.native.codec import decode_batch

        with self._req("GET", f"/topics/{topic}/{partition}/fetch"
                       f"?offset={offset}&max_bytes={max_bytes}") as r:
            nxt = int(r.headers["X-Next-Offset"])
            data = r.read()
        return [decode_batch(p) for p in iter_frames(data)], nxt


class LogServiceSource(Source):
    """FLIP-27 source over the broker: one split per partition, positions
    are byte offsets (the ``KafkaSource`` shape).  Bounded mode reads to the
    end offsets observed at split creation."""

    def __init__(self, url: str, topic: str,
                 timestamp_column: Optional[str] = None):
        self.url = url
        self.topic = topic
        self.timestamp_column = timestamp_column
        self.bounded = True

    def create_splits(self, parallelism: int) -> List[SourceSplit]:
        client = LogServiceClient(self.url)
        meta = client.meta(self.topic)
        return [LogServiceSplit(self, p, meta["num_partitions"],
                                end_offset=meta["end_offsets"][p])
                for p in range(meta["num_partitions"])]

    def read_partition(self, partition: int,
                       end_offset: int) -> Iterator[StreamElement]:
        client = LogServiceClient(self.url)
        off = 0
        max_bytes = 1 << 20
        while off < end_offset:
            batches, nxt = client.fetch(self.topic, partition, off,
                                        max_bytes=max_bytes)
            if nxt == off:
                # a single frame larger than the fetch window: grow and
                # retry (a fetch must always make progress, Kafka's
                # max.partition.fetch.bytes oversize-record behavior)
                if max_bytes >= 1 << 30:
                    raise IOError(
                        f"record batch at offset {off} exceeds 1GiB")
                max_bytes *= 2
                continue
            for b in batches:
                if self.timestamp_column is not None:
                    ts = np.asarray(b.column(self.timestamp_column),
                                    np.int64)
                    b = RecordBatch(dict(b.columns), timestamps=ts)
                    yield b
                    yield Watermark(int(ts.max()))
                else:
                    yield b
            off = nxt


class LogServiceSplit(SourceSplit):
    def __init__(self, source: LogServiceSource, index: int, of: int,
                 end_offset: int):
        super().__init__(source, index, of)
        self.end_offset = end_offset

    def split_id(self) -> str:
        return f"{self.source.topic}-{self.index}"

    def read(self) -> Iterator[StreamElement]:
        return self.source.read_partition(self.index, self.end_offset)


class LogServiceSink:
    """Exactly-once transactional sink into the broker: epochs stage in
    the checkpoint (2PC pre-commit); ``notify_checkpoint_complete`` appends
    with idempotent-producer sequences so replayed commits deduplicate
    broker-side (``KafkaSink`` EXACTLY_ONCE analog)."""

    clone_per_subtask = True

    def __init__(self, url: str, topic: str, num_partitions: int = 1,
                 key_column: Optional[str] = None, producer_id: str = ""):
        import uuid

        self.url = url
        self.topic = topic
        self.num_partitions = num_partitions
        self.key_column = key_column
        self.producer_id = producer_id or uuid.uuid4().hex[:12]
        self._client: Optional[LogServiceClient] = None
        self._epoch: List[RecordBatch] = []
        self._staged: Dict[int, List[RecordBatch]] = {}
        self._rr = 0

    def on_cloned(self) -> None:
        import uuid

        self.producer_id = uuid.uuid4().hex[:12]
        self._epoch = []
        self._staged = {}
        self._txn_ckpt = {}

    def _cli(self) -> LogServiceClient:
        if self._client is None:
            self._client = LogServiceClient(self.url)
            self._client.create_topic(self.topic, self.num_partitions)
        return self._client

    def open(self, ctx) -> None:
        self._cli()

    def write_batch(self, batch: RecordBatch) -> None:
        if len(batch):
            self._epoch.append(batch)

    # -- 2PC hooks (same contract as connectors.partitioned_log.LogSink:
    # snapshot PRE-COMMITS the epoch under an internal txn counter, notify
    # commits every staged txn; replayed commits after restore carry the
    # SAME producer sequences and deduplicate broker-side) -----------------
    def snapshot_state(self) -> Dict[str, Any]:
        from flink_tpu_torch.operators.base import current_checkpoint_id

        self._counter = getattr(self, "_counter", 0) + 1
        self._staged[self._counter] = self._epoch
        # txn -> checkpoint id: notify commits ONLY txns staged for
        # checkpoints <= the notified one (TwoPhaseCommitSinkFunction
        # contract) — if checkpoints ever pipeline, an epoch staged for a
        # later, uncompleted checkpoint must not commit early
        self._txn_ckpt = getattr(self, "_txn_ckpt", {})
        self._txn_ckpt[self._counter] = current_checkpoint_id()
        self._epoch = []
        staged = {cid: [{k: np.asarray(v) for k, v in b.columns.items()}
                        for b in bs] for cid, bs in self._staged.items()}
        # _rr rides the snapshot: a replayed commit must route each batch
        # to the SAME partition, or the per-partition seq dedup misses
        return {"staged": staged, "counter": self._counter,
                "producer_id": self.producer_id, "rr": self._rr,
                "txn_ckpt": dict(self._txn_ckpt)}

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        txn_ckpt = getattr(self, "_txn_ckpt", {})
        for cid in sorted(self._staged):
            staged_for = txn_ckpt.get(cid)
            # None = the runtime gave no id at snapshot time: the legacy
            # notify-before-next-barrier ordering applies — commit
            if staged_for is not None and staged_for > checkpoint_id:
                continue
            self._commit(cid)

    def _commit(self, cid: int) -> None:
        getattr(self, "_txn_ckpt", {}).pop(cid, None)
        for j, batch in enumerate(self._staged.pop(cid, [])):
            # seq = (txn << 20 | j): strictly increasing per producer and
            # identical on replay -> broker-side idempotent dedup
            for part, sub in self._route(batch):
                self._cli().append(self.topic, part, sub,
                                   producer=self.producer_id,
                                   seq=(cid << 20) | j)

    def _route(self, batch: RecordBatch):
        """(partition, sub-batch) routing: stable key hash keeps per-key
        ordering within a partition (LogSink._append semantics)."""
        n_p = self.num_partitions
        if self.key_column is None or n_p == 1:
            self._rr += 1
            return [(self._rr % n_p, batch)]
        from flink_tpu_torch.core.keygroups import hash_keys
        keys = np.asarray(batch.column(self.key_column))
        parts = (np.abs(hash_keys(keys).astype(np.int64)) % n_p)
        return [(int(p), batch.select(parts == p))
                for p in np.unique(parts).tolist()]

    def restore_state(self, snap: Dict[str, Any]) -> None:
        # adopt the snapshot's producer identity: replayed commits must
        # carry the same sequences to deduplicate
        self.producer_id = snap.get("producer_id", self.producer_id)
        self._counter = int(snap.get("counter", 0))
        self._rr = int(snap.get("rr", 0))
        self._epoch = []
        self._txn_ckpt = {int(cid): v
                          for cid, v in snap.get("txn_ckpt", {}).items()}
        self._staged = {int(cid): [RecordBatch(c) for c in bs]
                        for cid, bs in snap.get("staged", {}).items()}
        # txns staged in a completed checkpoint are owed to the broker
        for cid in sorted(self._staged):
            self._commit(cid)

    def flush(self) -> None:
        """Bounded end-of-input: staged (older) txns land before the final
        epoch's rows (consumer last-value-per-key ordering)."""
        for cid in sorted(self._staged):
            self._commit(cid)
        for j, batch in enumerate(self._epoch):
            for part, sub in self._route(batch):
                self._cli().append(self.topic, part, sub,
                                   producer=self.producer_id,
                                   seq=(1 << 40) | j)
        self._epoch = []

    def close(self) -> None:
        pass

"""RabbitMQ connector: AMQP 0-9-1 wire broker, client, source and sink.

The port's copy of ``flink_tpu/connectors/rabbitmq.py``: host Python as
JAX's, the same bytes on the wire and on disk, so either package's client
talks to the other's broker.

Analog of ``flink-connectors/flink-connector-rabbitmq`` (``RMQSource`` /
``RMQSink``): the sink publishes rows as JSON message bodies, the source
drains a queue with at-least-once acknowledgement semantics (messages ack
AFTER the checkpoint barrier, so a crash replays the unacked tail —
``RMQSource.acknowledgeSessionIDs``).

As with Kafka/Postgres/Elasticsearch, the wire dialect is implemented from
the public protocol spec on both sides: ``AmqpBroker`` speaks real AMQP
0-9-1 framing (protocol header, Connection.Start/Tune/Open,
Channel.Open, Queue.Declare, Basic.Publish/Get/Ack with content header +
body frames), so a real AMQP client library can complete the same
handshakes; ``AmqpClient`` is the socket client the connector uses.

Scope: the classes/methods the connector needs (connection, one channel,
durable-ignored queue declare, publish, pull-based get, ack).  Consumer
push (Basic.Consume/Deliver), exchanges beyond the default direct
exchange, and transactions are not implemented.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

from flink_tpu_torch.utils.servers import ConnectionThreads

PROTOCOL_HEADER = b"AMQP\x00\x00\x09\x01"
FRAME_METHOD, FRAME_HEADER, FRAME_BODY, FRAME_HEARTBEAT = 1, 2, 3, 8
FRAME_END = 0xCE

# class ids
C_CONNECTION, C_CHANNEL, C_QUEUE, C_BASIC = 10, 20, 50, 60
# connection methods
M_START, M_START_OK, M_TUNE, M_TUNE_OK = 10, 11, 30, 31
M_OPEN, M_OPEN_OK, M_CLOSE, M_CLOSE_OK = 40, 41, 50, 51
# channel methods
M_CH_OPEN, M_CH_OPEN_OK = 10, 11
# queue methods
M_Q_DECLARE, M_Q_DECLARE_OK = 10, 11
# basic methods
M_B_PUBLISH, M_B_GET, M_B_GET_OK = 40, 70, 71
M_B_GET_EMPTY, M_B_ACK = 72, 80


class AmqpError(Exception):
    pass


# ---------------------------------------------------------------------------
# wire primitives
# ---------------------------------------------------------------------------


def _short_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack("B", len(b)) + b


def _long_str(b: bytes) -> bytes:
    return struct.pack(">I", len(b)) + b


def _read_short_str(data: bytes, pos: int) -> Tuple[str, int]:
    n = data[pos]
    return data[pos + 1:pos + 1 + n].decode(), pos + 1 + n


def _frame(ftype: int, channel: int, payload: bytes) -> bytes:
    return struct.pack(">BHI", ftype, channel, len(payload)) \
        + payload + bytes([FRAME_END])


def _method(class_id: int, method_id: int, args: bytes = b"") -> bytes:
    return struct.pack(">HH", class_id, method_id) + args


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _read_frame(sock: socket.socket) -> Optional[Tuple[int, int, bytes]]:
    hdr = _recv_exact(sock, 7)
    if hdr is None:
        return None
    ftype, channel, size = struct.unpack(">BHI", hdr)
    payload = _recv_exact(sock, size)
    end = _recv_exact(sock, 1)
    if payload is None or end is None:
        return None
    if end[0] != FRAME_END:
        raise AmqpError(f"bad frame end {end!r}")
    return ftype, channel, payload


# ---------------------------------------------------------------------------
# broker
# ---------------------------------------------------------------------------


class AmqpBroker:
    """Single-node AMQP 0-9-1 broker: named queues of (delivery_tag-less)
    message bodies on the default exchange (routing key = queue name)."""

    FRAME_MAX = 1 << 20

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._lock = threading.Lock()
        self.queues: Dict[str, List[bytes]] = {}
        #: per-connection unacked messages: (conn id, delivery_tag) ->
        #: (queue, body) — un-acked messages REQUEUE when the connection
        #: drops (the at-least-once redelivery the source relies on)
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()[:2]
        self._stop = threading.Event()
        self._connections = ConnectionThreads("amqp-broker")
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="amqp-broker", daemon=True)
        self._thread.start()

    def declare_queue(self, name: str) -> int:
        with self._lock:
            q = self.queues.setdefault(name, [])
            return len(q)

    def _accept_loop(self) -> None:
        self._srv.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self._connections.start(self._serve, conn)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()
        try:
            self._srv.close()
        except OSError:
            pass
        self._connections.close()

    # -- connection state machine ------------------------------------------
    def _serve(self, sock: socket.socket) -> None:
        unacked: Dict[int, Tuple[str, bytes]] = {}
        try:
            hdr = _recv_exact(sock, 8)
            if hdr != PROTOCOL_HEADER:
                # spec: answer with the supported protocol header and close.
                # Drain the peer's unread bytes first — closing with data in
                # the receive buffer RSTs the connection and the peer may
                # never see the header
                try:
                    sock.sendall(PROTOCOL_HEADER)
                    sock.shutdown(socket.SHUT_WR)
                    sock.settimeout(1.0)
                    while sock.recv(4096):
                        pass
                except OSError:
                    pass
                finally:
                    sock.close()
                return
            # Connection.Start: version 0-9, empty server props,
            # PLAIN mechanism, en_US locales
            start = _method(C_CONNECTION, M_START,
                            struct.pack("BB", 0, 9) + _long_str(b"")
                            + _long_str(b"PLAIN") + _long_str(b"en_US"))
            sock.sendall(_frame(FRAME_METHOD, 0, start))
            self._expect(sock, C_CONNECTION, M_START_OK)
            tune = _method(C_CONNECTION, M_TUNE,
                           struct.pack(">HIH", 2047, self.FRAME_MAX, 0))
            sock.sendall(_frame(FRAME_METHOD, 0, tune))
            self._expect(sock, C_CONNECTION, M_TUNE_OK)
            self._expect(sock, C_CONNECTION, M_OPEN)
            sock.sendall(_frame(FRAME_METHOD, 0,
                                _method(C_CONNECTION, M_OPEN_OK,
                                        _short_str(""))))
            self._session(sock, unacked)
        except (OSError, AmqpError, _Closed):
            pass
        finally:
            # redeliver this connection's unacked messages (front of queue:
            # redelivery beats new arrivals, like a broker requeue)
            with self._lock:
                for tag in sorted(unacked, reverse=True):
                    qname, body = unacked[tag]
                    self.queues.setdefault(qname, []).insert(0, body)
            try:
                sock.close()
            except OSError:
                pass

    def _expect(self, sock, class_id: int, method_id: int) -> bytes:
        while True:
            fr = _read_frame(sock)
            if fr is None:
                raise _Closed()
            ftype, _ch, payload = fr
            if ftype == FRAME_HEARTBEAT:
                continue
            cid, mid = struct.unpack(">HH", payload[:4])
            if (cid, mid) != (class_id, method_id):
                raise AmqpError(f"expected {class_id}.{method_id}, "
                                f"got {cid}.{mid}")
            return payload[4:]

    def _session(self, sock: socket.socket,
                 unacked: Dict[int, Tuple[str, bytes]]) -> None:
        next_tag = 1
        pending_publish: Optional[Tuple[str, int]] = None  # (queue, size)
        pending_body = b""
        while True:
            fr = _read_frame(sock)
            if fr is None:
                raise _Closed()
            ftype, channel, payload = fr
            if ftype == FRAME_HEARTBEAT:
                continue
            if ftype == FRAME_HEADER and pending_publish is not None:
                # content header: class, weight, body size, property flags
                _cls, _w, size = struct.unpack(">HHQ", payload[:12])
                pending_publish = (pending_publish[0], size)
                if size == 0:
                    self._enqueue(pending_publish[0], b"")
                    pending_publish = None
                continue
            if ftype == FRAME_BODY and pending_publish is not None:
                pending_body += payload
                if len(pending_body) >= pending_publish[1]:
                    self._enqueue(pending_publish[0], pending_body)
                    pending_publish = None
                    pending_body = b""
                continue
            if ftype != FRAME_METHOD:
                raise AmqpError(f"unexpected frame type {ftype}")
            cid, mid = struct.unpack(">HH", payload[:4])
            args = payload[4:]
            if (cid, mid) == (C_CHANNEL, M_CH_OPEN):
                sock.sendall(_frame(FRAME_METHOD, channel,
                                    _method(C_CHANNEL, M_CH_OPEN_OK,
                                            _long_str(b""))))
            elif (cid, mid) == (C_QUEUE, M_Q_DECLARE):
                # ticket(2) queue(shortstr) flags(1) arguments(table)
                qname, _pos = _read_short_str(args, 2)
                n = self.declare_queue(qname)
                ok = _method(C_QUEUE, M_Q_DECLARE_OK,
                             _short_str(qname) + struct.pack(">II", n, 0))
                sock.sendall(_frame(FRAME_METHOD, channel, ok))
            elif (cid, mid) == (C_BASIC, M_B_PUBLISH):
                # ticket(2) exchange(shortstr) routing-key(shortstr) bits
                _ex, pos = _read_short_str(args, 2)
                rkey, _pos = _read_short_str(args, pos)
                pending_publish = (rkey, -1)
                pending_body = b""
            elif (cid, mid) == (C_BASIC, M_B_GET):
                # ticket(2) queue(shortstr) no-ack bit
                qname, pos = _read_short_str(args, 2)
                no_ack = bool(args[pos] & 1) if pos < len(args) else False
                with self._lock:
                    q = self.queues.get(qname, [])
                    body = q.pop(0) if q else None
                    remaining = len(q)
                if body is None:
                    sock.sendall(_frame(
                        FRAME_METHOD, channel,
                        _method(C_BASIC, M_B_GET_EMPTY, _short_str(""))))
                    continue
                tag = next_tag
                next_tag += 1
                if not no_ack:
                    unacked[tag] = (qname, body)
                ok = _method(C_BASIC, M_B_GET_OK,
                             struct.pack(">QB", tag, 0) + _short_str("")
                             + _short_str(qname)
                             + struct.pack(">I", remaining))
                hdr = struct.pack(">HHQH", C_BASIC, 0, len(body), 0)
                out = (_frame(FRAME_METHOD, channel, ok)
                       + _frame(FRAME_HEADER, channel, hdr))
                # bodies SPLIT at the negotiated frame-max (spec 4.2.3:
                # an oversized frame is a framing error to real clients)
                limit = self.FRAME_MAX - 8
                for lo in range(0, len(body), limit):
                    out += _frame(FRAME_BODY, channel, body[lo:lo + limit])
                sock.sendall(out)
            elif (cid, mid) == (C_BASIC, M_B_ACK):
                tag, bits = struct.unpack(">QB", args[:9])
                multiple = bool(bits & 1)
                if multiple:
                    for t in [t for t in unacked if t <= tag]:
                        unacked.pop(t)
                else:
                    unacked.pop(tag, None)
            elif (cid, mid) == (C_CONNECTION, M_CLOSE):
                sock.sendall(_frame(FRAME_METHOD, 0,
                                    _method(C_CONNECTION, M_CLOSE_OK)))
                return   # unacked messages REQUEUE (spec: closing a
                #          connection requeues; only Basic.Ack is final)
            else:
                raise AmqpError(f"unsupported method {cid}.{mid}")

    def _enqueue(self, queue: str, body: bytes) -> None:
        with self._lock:
            self.queues.setdefault(queue, []).append(body)


class _Closed(Exception):
    pass


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class AmqpClient:
    """Minimal AMQP 0-9-1 client: connection + one channel, declare /
    publish / get / ack."""

    def __init__(self, host: str, port: int, timeout_s: float = 10.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout_s)
        try:
            self.sock.sendall(PROTOCOL_HEADER)
            self._expect(C_CONNECTION, M_START)
            # PLAIN response with empty credentials (the broker is open)
            start_ok = _method(
                C_CONNECTION, M_START_OK,
                _long_str(b"") + _short_str("PLAIN")
                + _long_str(b"\x00guest\x00guest") + _short_str("en_US"))
            self.sock.sendall(_frame(FRAME_METHOD, 0, start_ok))
            self._expect(C_CONNECTION, M_TUNE)
            self.sock.sendall(_frame(
                FRAME_METHOD, 0,
                _method(C_CONNECTION, M_TUNE_OK,
                        struct.pack(">HIH", 2047, AmqpBroker.FRAME_MAX,
                                    0))))
            self.sock.sendall(_frame(
                FRAME_METHOD, 0,
                _method(C_CONNECTION, M_OPEN, _short_str("/")
                        + _short_str("") + b"\x00")))
            self._expect(C_CONNECTION, M_OPEN_OK)
            self.sock.sendall(_frame(FRAME_METHOD, 1,
                                     _method(C_CHANNEL, M_CH_OPEN,
                                             _short_str(""))))
            self._expect(C_CHANNEL, M_CH_OPEN_OK)
        except BaseException:
            self.sock.close()
            raise

    def _expect(self, class_id: int, method_id: int) -> bytes:
        while True:
            fr = _read_frame(self.sock)
            if fr is None:
                raise AmqpError("connection closed")
            ftype, _ch, payload = fr
            if ftype == FRAME_HEARTBEAT:
                continue
            cid, mid = struct.unpack(">HH", payload[:4])
            if (cid, mid) != (class_id, method_id):
                raise AmqpError(f"expected {class_id}.{method_id}, "
                                f"got {cid}.{mid}")
            return payload[4:]

    def queue_declare(self, queue: str) -> int:
        """-> message count currently in the queue."""
        self.sock.sendall(_frame(
            FRAME_METHOD, 1,
            _method(C_QUEUE, M_Q_DECLARE,
                    b"\x00\x00" + _short_str(queue) + b"\x00"
                    + struct.pack(">I", 0))))
        args = self._expect(C_QUEUE, M_Q_DECLARE_OK)
        _name, pos = _read_short_str(args, 0)
        n, _c = struct.unpack(">II", args[pos:pos + 8])
        return n

    def publish(self, queue: str, body: bytes) -> None:
        pub = _method(C_BASIC, M_B_PUBLISH,
                      b"\x00\x00" + _short_str("") + _short_str(queue)
                      + b"\x00")
        hdr = struct.pack(">HHQH", C_BASIC, 0, len(body), 0)
        frames = (_frame(FRAME_METHOD, 1, pub)
                  + _frame(FRAME_HEADER, 1, hdr))
        limit = AmqpBroker.FRAME_MAX - 8     # split at the negotiated max
        for lo in range(0, len(body), limit):
            frames += _frame(FRAME_BODY, 1, body[lo:lo + limit])
        self.sock.sendall(frames)

    def get(self, queue: str, no_ack: bool = False
            ) -> Optional[Tuple[int, bytes]]:
        """-> (delivery_tag, body) or None when the queue is empty."""
        self.sock.sendall(_frame(
            FRAME_METHOD, 1,
            _method(C_BASIC, M_B_GET,
                    b"\x00\x00" + _short_str(queue)
                    + (b"\x01" if no_ack else b"\x00"))))
        fr = _read_frame(self.sock)
        if fr is None:
            raise AmqpError("connection closed")
        _ftype, _ch, payload = fr
        cid, mid = struct.unpack(">HH", payload[:4])
        if (cid, mid) == (C_BASIC, M_B_GET_EMPTY):
            return None
        if (cid, mid) != (C_BASIC, M_B_GET_OK):
            raise AmqpError(f"unexpected {cid}.{mid}")
        tag = struct.unpack(">Q", payload[4:12])[0]
        fr = _read_frame(self.sock)             # content header
        if fr is None:
            raise AmqpError("connection closed mid-get")
        size = struct.unpack(">HHQ", fr[2][:12])[2]
        body = b""
        while len(body) < size:
            fr = _read_frame(self.sock)
            if fr is None:
                raise AmqpError("connection closed mid-get")
            body += fr[2]
        return tag, body

    def ack(self, delivery_tag: int, multiple: bool = False) -> None:
        self.sock.sendall(_frame(
            FRAME_METHOD, 1,
            _method(C_BASIC, M_B_ACK,
                    struct.pack(">QB", delivery_tag,
                                1 if multiple else 0))))

    def close(self) -> None:
        try:
            self.sock.sendall(_frame(
                FRAME_METHOD, 0,
                _method(C_CONNECTION, M_CLOSE,
                        struct.pack(">H", 200) + _short_str("bye")
                        + struct.pack(">HH", 0, 0))))
            self._expect(C_CONNECTION, M_CLOSE_OK)
        except (OSError, AmqpError):
            pass
        self.sock.close()


# ---------------------------------------------------------------------------
# source / sink
# ---------------------------------------------------------------------------


class RmqSink:
    """``RMQSink`` analog: rows publish as JSON bodies (at-least-once)."""

    clone_per_subtask = True

    def __init__(self, host: str, port: int, queue: str):
        self.host, self.port, self.queue = host, port, queue
        self._client: Optional[AmqpClient] = None

    def _cli(self) -> AmqpClient:
        if self._client is None:
            self._client = AmqpClient(self.host, self.port)
            self._client.queue_declare(self.queue)
        return self._client

    def open(self, ctx) -> None:
        self._cli()

    def write_batch(self, batch) -> None:
        from flink_tpu_torch.connectors.util import json_default
        c = self._cli()
        for r in batch.to_rows():
            c.publish(self.queue, json.dumps(
                r, default=json_default).encode())

    def close(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None


class RmqSource:
    """``RMQSource`` analog: drain a queue, acking only when the drain
    COMPLETES — messages stay unacked for the whole read, so a crash
    anywhere mid-job redelivers everything (at-least-once; the reference
    gets exactly-once only with correlation ids + a dedup state, the same
    recipe a keyed dedup downstream gives here)."""

    bounded = True

    def __init__(self, host: str, port: int, queue: str,
                 batch_rows: int = 1024,
                 timestamp_column: Optional[str] = None):
        self.host, self.port, self.queue = host, port, queue
        self.batch_rows = batch_rows
        self.timestamp_column = timestamp_column

    def create_splits(self, parallelism: int):
        from flink_tpu_torch.connectors.sources import SourceSplit

        src = self

        class _Split(SourceSplit):
            def split_id(_self) -> str:
                return f"{src.queue}-0"

            def read(_self):
                return src._drain()

        return [_Split(self, 0, 1)]

    def _drain(self):
        from flink_tpu_torch.core.batch import RecordBatch

        c = AmqpClient(self.host, self.port)
        try:
            c.queue_declare(self.queue)
            rows: List[dict] = []
            last_tag: Optional[int] = None
            while True:
                got = c.get(self.queue)
                if got is None:
                    break
                tag, body = got
                rows.append(json.loads(body.decode()))
                last_tag = tag
                if len(rows) >= self.batch_rows:
                    yield self._batch(rows, RecordBatch)
                    rows = []
            if rows:
                yield self._batch(rows, RecordBatch)
            if last_tag is not None:
                # ack ONLY at full-drain completion: an earlier ack would
                # let a crash lose the acked tail before any checkpoint
                # covered it
                c.ack(last_tag, multiple=True)
        finally:
            c.close()

    def _batch(self, rows, _RecordBatch):
        from flink_tpu_torch.connectors.util import rows_to_batch
        return rows_to_batch(rows, self.timestamp_column)

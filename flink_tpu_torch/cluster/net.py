"""Cross-host data plane: TCP channels with credit-based flow control
(port of ``flink_tpu/cluster/net.py``; host Python as JAX's, batches
framed by the port's ``native/codec.py`` over ``csrc/codec.cc``).

The inter-host analog of the reference's Netty shuffle
(``NettyServer.java`` / ``NettyMessage.java``: ``PartitionRequest``,
``BufferResponse:254``, ``AddCredit:678``; credit accounting in
``RemoteInputChannel.java:101,302``): intra-pod record exchange rides device
collectives (``parallel/exchange.py``), and THIS module is the host/DCN tier
— one :class:`ChannelServer` per receiving process, writers connect per
logical channel, record batches travel as FTB frames (the native codec, with
block compression), control elements as JSON frames.

Flow control mirrors the reference's credit protocol: the receiver grants an
initial per-channel credit budget (its buffer queue capacity); every element
costs one credit; the consumer draining its queue returns credits to the
sender.  A writer with zero credits blocks — the sender-side backpressure
that keeps a slow consumer from being buried (never TCP head-of-line
blocking across channels: each channel has its own connection + budget).

Wire format per frame:  ``type u8 | length u32le | payload``
  type 0 = RecordBatch (FTB), 1 = control element (JSON),
  type 2 = credit grant (receiver -> sender, count u32 payload),
  type 3 = handshake (sender -> receiver:
           ``mac_len u8 | mac | channel id utf-8``),
  type 4 = tagged batch (side output): tag length u16le | tag utf-8 | FTB,
  type 5 = challenge (receiver -> sender on accept: nonce bytes).

**Authentication:** batches carry pickled object columns, so the receiver
must never decode a frame from an unauthenticated peer.  On accept the
server sends a ``_CHALLENGE`` nonce; the sender's HELLO carries
``HMAC-SHA256(token, nonce + channel_id)``.  A server configured with an
``auth_token`` drops any connection whose MAC fails BEFORE decoding
anything else; TLS (mutual) is layered underneath via ``ssl_context``.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import json
import os
import socket
import struct
import threading
from collections import deque
from typing import Dict, Optional

from flink_tpu_torch.core.batch import (CheckpointBarrier, EndOfInput,
                                        LatencyMarker, RecordBatch, StreamElement,
                                        StreamStatus, TaggedBatch, Watermark)

_HDR = struct.Struct("<BI")
_BATCH, _CONTROL, _CREDIT, _HELLO, _TAGGED, _CHALLENGE = 0, 1, 2, 3, 4, 5


def _mac(token: str, nonce: bytes, channel_id: bytes) -> bytes:
    return hmac_mod.new(token.encode(), nonce + channel_id,
                        hashlib.sha256).digest()


_LOOPBACK = ("127.0.0.1", "localhost", "::1")


def require_secure_bind(host: str, has_tls: bool, role: str,
                        detail: str = "") -> None:
    """Single policy for every listening endpoint: a non-loopback bind
    requires TLS (the reference's ``security.ssl.internal.enabled``
    posture); ``FLINK_TPU_ALLOW_INSECURE=1`` overrides for trusted
    networks.  Token-only auth gates handshakes but cannot stop an on-path
    attacker injecting frames into an established stream — hence TLS."""
    if host in _LOOPBACK or has_tls:
        return
    if os.environ.get("FLINK_TPU_ALLOW_INSECURE") == "1":
        return
    raise ValueError(
        f"{role} would bind {host!r} (non-loopback) without TLS{detail}; "
        f"configure mutual TLS or set FLINK_TPU_ALLOW_INSECURE=1 for a "
        f"trusted network")


def _encode_control(el: StreamElement) -> bytes:
    if isinstance(el, Watermark):
        d = {"t": "wm", "ts": el.timestamp}
    elif isinstance(el, CheckpointBarrier):
        d = {"t": "barrier", "id": el.checkpoint_id, "ts": el.timestamp,
             "sp": el.is_savepoint}
    elif isinstance(el, EndOfInput):
        d = {"t": "eoi"}
    elif isinstance(el, StreamStatus):
        d = {"t": "status", "idle": el.idle}
    elif isinstance(el, LatencyMarker):
        d = {"t": "latency", "mt": el.marked_time, "src": el.source_id,
             "sub": el.subtask_index, "name": el.source}
    else:
        raise TypeError(f"not wire-encodable: {type(el).__name__}")
    return json.dumps(d).encode()


def _decode_control(payload: bytes) -> StreamElement:
    d = json.loads(payload)
    t = d["t"]
    if t == "wm":
        return Watermark(d["ts"])
    if t == "barrier":
        return CheckpointBarrier(d["id"], d["ts"], d["sp"])
    if t == "eoi":
        return EndOfInput()
    if t == "status":
        return StreamStatus(d["idle"])
    if t == "latency":
        return LatencyMarker(d["mt"], d["src"], d["sub"], d.get("name", ""))
    raise ValueError(f"unknown control frame {t!r}")


def _send_frame(sock: socket.socket, ftype: int, payload: bytes) -> None:
    sock.sendall(_HDR.pack(ftype, len(payload)) + payload)


def recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly ``n`` bytes or return None on EOF — the shared socket
    primitive of every framed protocol in the repo (data plane here, the
    queryable serving tier's wire layer, the control planes)."""
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


_recv_exact = recv_exact


def _recv_frame(sock: socket.socket):
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None, None
    ftype, ln = _HDR.unpack(hdr)
    payload = _recv_exact(sock, ln) if ln else b""
    if ln and payload is None:
        return None, None
    return ftype, payload


class _ReceiveQueue:
    """Server-side channel queue; polling returns credits to the sender
    (``RemoteInputChannel.notifyCreditAvailable`` direction)."""

    def __init__(self, capacity: int, name: str = ""):
        self.capacity = capacity
        self.name = name
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._conn: Optional[socket.socket] = None
        self._closed = False
        #: remote channels measure producer credit-waits sender-side; the
        #: consumer-side gauge stays 0 here (shape parity w/ LocalChannel)
        self.backpressured_ns = 0
        #: queued-barrier announcement (LocalChannel contract)
        self._announced: deque = deque()

    def _attach(self, conn: socket.socket) -> None:
        with self._lock:
            self._conn = conn

    def _push(self, el: StreamElement) -> None:
        from flink_tpu_torch.core.batch import CheckpointBarrier
        with self._not_empty:
            self._q.append(el)
            if isinstance(el, CheckpointBarrier):
                self._announced.append(el.checkpoint_id)
            self._not_empty.notify()

    def announced_barrier(self) -> Optional[int]:
        with self._lock:
            return self._announced[0] if self._announced else None

    def poll(self, timeout_s: float = 0.0) -> Optional[StreamElement]:
        from flink_tpu_torch.core.batch import CheckpointBarrier
        with self._not_empty:
            if not self._q and timeout_s > 0:
                self._not_empty.wait(timeout=timeout_s)
            if not self._q:
                return None
            el = self._q.popleft()
            if isinstance(el, CheckpointBarrier) and self._announced:
                self._announced.popleft()
            conn = self._conn
        if conn is not None:
            try:
                _send_frame(conn, _CREDIT, struct.pack("<I", 1))
            except OSError:
                pass
        # slow-consumer drain stall (chaos.SlowConsumer) — after the credit
        # returns so the stall models the CONSUMER, not the link
        from flink_tpu_torch.testing import chaos
        chaos.fire("channel.recv", channel=self.name)
        return el

    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def queued_bytes(self) -> int:
        from flink_tpu_torch.cluster.channels import element_bytes
        with self._lock:
            return sum(element_bytes(el) for el in self._q)

    def take_until_barrier(self, checkpoint_id: int):
        """Barrier overtake on a remote input channel: extract the queued
        elements in front of checkpoint ``checkpoint_id``'s barrier (the
        SHARED extraction loop of ``channels.take_until_barrier_locked`` —
        returns the consumed barrier element or None).  Credits for every
        consumed element (barrier included) still flow back to the
        sender."""
        from flink_tpu_torch.cluster.channels import take_until_barrier_locked
        with self._not_empty:
            out, barrier = take_until_barrier_locked(
                self._q, self._announced, checkpoint_id)
            conn = self._conn
        credits = len(out) + (1 if barrier is not None else 0)
        if conn is not None and credits:
            try:
                _send_frame(conn, _CREDIT, struct.pack("<I", credits))
            except OSError:
                pass
        return out, barrier

    def close(self) -> None:
        with self._not_empty:
            self._closed = True
            self._not_empty.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)


class ChannelServer:
    """Receiving endpoint: one TCP server, one queue per logical channel.

    ``ssl_context``: a server-side context (mutual TLS — see
    ``security/ssl_context.py``) wraps every accepted connection, the
    ``security.ssl.internal.enabled`` data-plane encryption of the
    reference."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 channel_capacity: int = 32, ssl_context=None,
                 auth_token: Optional[str] = None):
        require_secure_bind(host, ssl_context is not None, "ChannelServer",
                            detail=" (batches carry pickled columns)")
        #: coordinator HA: data-plane epoch fence — a channel
        #: HELLO carrying a LOWER (non-zero) leader epoch is a stale
        #: incarnation's writer and is rejected before any decode.  Workers
        #: raise this as they adopt higher epochs; 0 admits everything.
        self.min_epoch = 0
        self.channel_capacity = channel_capacity
        self._ssl = ssl_context
        self._auth_token = auth_token
        self._queues: Dict[str, _ReceiveQueue] = {}
        self._lock = threading.Lock()
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()[:2]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="channel-server", daemon=True)
        self._thread.start()

    def channel(self, channel_id: str) -> _ReceiveQueue:
        """The consumer-side queue (poll/close/len — LocalChannel shape)."""
        with self._lock:
            q = self._queues.get(channel_id)
            if q is None:
                q = self._queues[channel_id] = _ReceiveQueue(
                    self.channel_capacity, name=channel_id)
            return q

    def _accept_loop(self) -> None:
        self._srv.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _addr = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        from flink_tpu_torch.native.codec import decode_batch

        try:
            if self._ssl is not None:
                # handshake on the connection thread (it can block)
                conn = self._ssl.wrap_socket(conn, server_side=True)
            # a pre-auth peer must not stall the thread or feed us frames:
            # bounded handshake window, MAC verified before ANY decode
            conn.settimeout(30)
            nonce = os.urandom(32)
            _send_frame(conn, _CHALLENGE, nonce)
            ftype, payload = _recv_frame(conn)
            if ftype != _HELLO or not payload:
                conn.close()
                return
            mac_len = payload[0]
            mac, rest = payload[1:1 + mac_len], payload[1 + mac_len:]
            if len(rest) < 8:
                conn.close()
                return
            (epoch,) = struct.unpack("<Q", rest[:8])
            chan = rest[8:]
            if self._auth_token is not None and not hmac_mod.compare_digest(
                    _mac(self._auth_token, nonce, rest), mac):
                conn.close()
                return
            if epoch and epoch < self.min_epoch:
                # stale-incarnation writer (zombie ex-leader's deploy):
                # reject before attaching — its batches never decode
                conn.close()
                return
            conn.settimeout(None)
            q = self.channel(chan.decode())
            q._attach(conn)
            # initial credit grant = queue capacity (exclusive buffers)
            _send_frame(conn, _CREDIT, struct.pack("<I", q.capacity))
            while not self._stop.is_set():
                ftype, payload = _recv_frame(conn)
                if ftype is None:
                    return
                if ftype == _BATCH:
                    q._push(decode_batch(payload))
                elif ftype == _CONTROL:
                    q._push(_decode_control(payload))
                elif ftype == _TAGGED:
                    (tlen,) = struct.unpack("<H", payload[:2])
                    tag = payload[2:2 + tlen].decode()
                    q._push(TaggedBatch(tag,
                                        decode_batch(payload[2 + tlen:])))
        except (OSError, ValueError):
            return
        finally:
            conn.close()

    def reset(self) -> None:
        """Drop all channel queues (worker recovery: fresh deploys create
        fresh channels; stale connections keep pushing into the detached
        old queues, which nothing polls).  The server socket stays up — the
        worker's advertised address survives the recovery."""
        with self._lock:
            old = list(self._queues.values())
            self._queues = {}
        for q in old:
            q.close()

    def reset_channels(self, channel_ids) -> None:
        """Region-scoped recovery: drop ONLY these channels' queues (the
        affected region's), leaving unaffected regions' channels streaming
        undisturbed."""
        with self._lock:
            old = [self._queues.pop(cid) for cid in channel_ids
                   if cid in self._queues]
        for q in old:
            q.close()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            for q in self._queues.values():
                q.close()


class RemoteChannel:
    """Sender side: LocalChannel-shaped ``put`` over TCP with credits."""

    def __init__(self, host: str, port: int, channel_id: str,
                 connect_timeout_s: float = 10.0, ssl_context=None,
                 auth_token: Optional[str] = None, epoch: int = 0):
        self.channel_id = channel_id
        #: leader epoch this writer was deployed under; the
        #: HELLO carries it and servers reject stale incarnations
        self.epoch = int(epoch)
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout_s)
        if ssl_context is not None:
            self._sock = ssl_context.wrap_socket(self._sock,
                                                 server_hostname=host)
        self._sock.settimeout(None)
        self._auth_token = auth_token
        self._credits = 0
        self._lock = threading.Lock()
        self._have_credit = threading.Condition(self._lock)
        self._closed = False
        #: set when the connection died before the server ever granted
        #: credit — a rejected handshake (auth failure), which must surface
        #: as an error, not as silent backpressure-drop
        self._error: Optional[str] = None
        self._got_credit = False
        self._reader = threading.Thread(target=self._credit_loop,
                                        name=f"credits-{channel_id}",
                                        daemon=True)
        self._reader.start()

    def _credit_loop(self) -> None:
        # answer the server's challenge first (HELLO carries the HMAC over
        # nonce + channel id); credits only start flowing once the server
        # accepted it, so put() blocks until the channel is authenticated
        try:
            ftype, nonce = _recv_frame(self._sock)
            if ftype != _CHALLENGE:
                raise OSError("bad data-plane challenge")
            # HELLO = mac_len | mac | epoch u64 | channel id; the MAC
            # covers epoch + channel id, so a stale epoch cannot be
            # stripped or rewritten by an on-path peer
            rest = struct.pack("<Q", self.epoch) + self.channel_id.encode()
            mac = (_mac(self._auth_token, nonce, rest)
                   if self._auth_token else b"")
            _send_frame(self._sock, _HELLO, bytes([len(mac)]) + mac + rest)
        except OSError as e:
            with self._have_credit:
                self._closed = True
                self._error = f"channel {self.channel_id}: handshake failed ({e})"
                self._have_credit.notify_all()
            return
        while True:
            try:
                ftype, payload = _recv_frame(self._sock)
            except OSError:
                ftype = None  # reset by peer == closed
            if ftype is None:
                with self._have_credit:
                    if not self._got_credit and not self._closed \
                            and self._auth_token is not None:
                        # server hung up before the initial credit grant on
                        # an authenticated channel: the HELLO was rejected
                        # (bad/missing MAC).  A local close() or a token-less
                        # channel stays a benign close (put returns False).
                        self._error = (
                            f"channel {self.channel_id}: connection rejected "
                            f"before any credit grant — data-plane "
                            f"authentication failed (token mismatch?)")
                    self._closed = True
                    self._have_credit.notify_all()
                return
            if ftype == _CREDIT:
                (n,) = struct.unpack("<I", payload)
                with self._have_credit:
                    self._got_credit = True
                    self._credits += n
                    self._have_credit.notify_all()

    def put(self, el: StreamElement,
            timeout_s: Optional[float] = None) -> bool:
        from flink_tpu_torch.native.codec import encode_batch

        with self._have_credit:
            while self._credits <= 0 and not self._closed:
                if not self._have_credit.wait(timeout=timeout_s):
                    return False
            if self._closed:
                if self._error is not None:
                    # auth rejection: dropping silently would let the job
                    # "succeed" with missing data — fail the producer task
                    raise ConnectionError(self._error)
                return False
            self._credits -= 1
        try:
            if isinstance(el, RecordBatch):
                _send_frame(self._sock, _BATCH, encode_batch(el))
            elif isinstance(el, TaggedBatch):
                tag = el.tag.encode()
                _send_frame(self._sock, _TAGGED,
                            struct.pack("<H", len(tag)) + tag
                            + encode_batch(el.batch))
            else:
                _send_frame(self._sock, _CONTROL, _encode_control(el))
            return True
        except OSError:
            with self._have_credit:
                self._closed = True
            return False

    def close(self) -> None:
        with self._have_credit:
            self._closed = True
            self._have_credit.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass

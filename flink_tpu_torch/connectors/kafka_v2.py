"""Kafka modern protocol: v2 record batches + consumer-group coordination
(port of ``flink_tpu/connectors/kafka_v2.py``; the batches' CRC-32C goes
through the port's ``native.crc32c`` over ``csrc/codec.cc``).

Extends the v0 wire dialect (:mod:`flink_tpu_torch.connectors.kafka`) with the
format every broker of the last decade speaks — matching what the
reference's connector is built on
(``flink-connectors/flink-connector-kafka/src/main/java/org/apache/flink/
connector/kafka/source/KafkaSource.java:1``, reader/enumerator under
``source/``):

- **Record batch (magic 2)**: the ``baseOffset/batchLength/
  partitionLeaderEpoch/magic/crc/attributes/...`` header with **CRC32C**
  over attributes..end, followed by varint-delta records
  (``length, attributes, timestampDelta, offsetDelta, key, value,
  headers``) — all varints zigzag-encoded.
- **Group coordination APIs**: FindCoordinator(10), JoinGroup(11),
  Heartbeat(12), LeaveGroup(13), SyncGroup(14) with the consumer
  subscription/assignment embedded protocol, and committed offsets via
  OffsetCommit(8) v2 / OffsetFetch(9) v1.

:class:`KafkaGroupConsumer` runs the full client-side dance (join →
leader-side range assignment → sync → heartbeat → commit);
:class:`KafkaGroupSource` adapts it to the framework's source seam with
committed-offset restart.  The broker side lives in
:class:`~flink_tpu_torch.connectors.kafka.KafkaWireBroker` (same listener, new
APIs).
"""

from __future__ import annotations

import struct
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.connectors.kafka import (KafkaWireClient, _Reader,
                                              _Writer)
from flink_tpu_torch.native import crc32c

# api keys (real protocol numbers)
API_OFFSET_COMMIT = 8
API_OFFSET_FETCH = 9
API_FIND_COORDINATOR = 10
API_JOIN_GROUP = 11
API_HEARTBEAT = 12
API_LEAVE_GROUP = 13
API_SYNC_GROUP = 14

# error codes (real protocol numbers)
ERR_NONE = 0
ERR_NOT_COORDINATOR = 16
ERR_ILLEGAL_GENERATION = 22
ERR_UNKNOWN_MEMBER_ID = 25
ERR_REBALANCE_IN_PROGRESS = 27


# ---------------------------------------------------------------------------
# varint (zigzag) — record-level integers in the v2 format
# ---------------------------------------------------------------------------

def _zz_enc(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def _zz_dec(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def write_varint(out: bytearray, v: int) -> None:
    u = _zz_enc(v) & 0xFFFFFFFFFFFFFFFF
    while u >= 0x80:
        out.append((u & 0x7F) | 0x80)
        u >>= 7
    out.append(u)


def read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    u = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        u |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
        if shift > 63:
            raise ValueError("malformed varint")
    return _zz_dec(u), pos


# ---------------------------------------------------------------------------
# record batch v2 codec
# ---------------------------------------------------------------------------

#: (timestamp_ms, key|None, value|None, headers=[(str, bytes|None)])
Record = Tuple[int, Optional[bytes], Optional[bytes],
               List[Tuple[str, Optional[bytes]]]]


def encode_record_batch(base_offset: int, records: List[Record],
                        producer_id: int = -1, producer_epoch: int = -1,
                        transactional: bool = False) -> bytes:
    """One magic-2 batch.  CRC32C covers attributes..end (the bytes after
    the crc field), exactly as brokers verify it.  ``producer_id`` /
    ``producer_epoch`` + the transactional attribute bit (0x10) mark the
    batch as part of a transaction — the broker fences stale epochs with
    them (KIP-98 exactly-once produce)."""
    if not records:
        return b""
    base_ts = min(r[0] for r in records)
    max_ts = max(r[0] for r in records)
    recs = bytearray()
    for i, (ts, key, value, headers) in enumerate(records):
        body = bytearray()
        body.append(0)                               # record attributes
        write_varint(body, ts - base_ts)             # timestampDelta
        write_varint(body, i)                        # offsetDelta
        if key is None:
            write_varint(body, -1)
        else:
            write_varint(body, len(key))
            body += key
        if value is None:
            write_varint(body, -1)
        else:
            write_varint(body, len(value))
            body += value
        write_varint(body, len(headers))
        for hk, hv in headers:
            hkb = hk.encode()
            write_varint(body, len(hkb))
            body += hkb
            if hv is None:
                write_varint(body, -1)
            else:
                write_varint(body, len(hv))
                body += hv
        write_varint(recs, len(body))
        recs += body
    # attributes(2) lastOffsetDelta(4) baseTs(8) maxTs(8) producerId(8)
    # producerEpoch(2) baseSequence(4) recordCount(4)
    attrs = 0x10 if transactional else 0
    after_crc = struct.pack(">hiqqqhii", attrs, len(records) - 1, base_ts,
                            max_ts, producer_id, producer_epoch, -1,
                            len(records)) + bytes(recs)
    crc = crc32c(after_crc)
    # partitionLeaderEpoch(4) magic(1) crc(4) + after_crc
    batch_tail = struct.pack(">ibI", 0, 2, crc) + after_crc
    return struct.pack(">qi", base_offset, len(batch_tail)) + batch_tail


#: decoded record: (offset, timestamp_ms, key, value, headers)
DecodedRecord = Tuple[int, int, Optional[bytes], Optional[bytes],
                      List[Tuple[str, Optional[bytes]]]]


def batch_producer_info(data: bytes) -> Tuple[int, int, bool]:
    """(producer_id, producer_epoch, transactional) of the FIRST batch in
    ``data`` — the fencing fields a broker reads before accepting a
    transactional produce.  (-1, -1, False) when absent/short."""
    # header: baseOffset(8) batchLen(4) leaderEpoch(4) magic(1) crc(4)
    # attributes(2) lastOffsetDelta(4) baseTs(8) maxTs(8) producerId(8)
    # producerEpoch(2)
    if len(data) < 53:
        return -1, -1, False
    (attrs,) = struct.unpack_from(">h", data, 21)
    pid, epoch = struct.unpack_from(">qh", data, 43)
    return pid, epoch, bool(attrs & 0x10)


def decode_record_batches(data: bytes) -> List[DecodedRecord]:
    """Every complete batch in ``data`` (a trailing partial batch — legal in
    fetch responses — is skipped); CRC32C-verified."""
    out: List[DecodedRecord] = []
    pos = 0
    while len(data) - pos >= 12:
        base_offset, batch_len = struct.unpack_from(">qi", data, pos)
        if len(data) - pos - 12 < batch_len:
            break                                    # partial trailing batch
        tail = data[pos + 12: pos + 12 + batch_len]
        pos += 12 + batch_len
        _epoch, magic = struct.unpack_from(">ib", tail, 0)
        if magic != 2:
            raise ValueError(f"unsupported batch magic {magic}")
        (crc,) = struct.unpack_from(">I", tail, 5)
        after = tail[9:]
        if crc32c(after) != crc:
            raise ValueError(
                f"record batch CRC32C mismatch at offset {base_offset}")
        (_attrs, _last_delta, base_ts, _max_ts, _pid, _pepoch, _bseq,
         count) = struct.unpack_from(">hiqqqhii", after, 0)
        p = struct.calcsize(">hiqqqhii")
        for _ in range(count):
            rec_len, p = read_varint(after, p)
            rec_end = p + rec_len
            p += 1                                   # record attributes
            ts_delta, p = read_varint(after, p)
            off_delta, p = read_varint(after, p)
            klen, p = read_varint(after, p)
            key = None if klen < 0 else after[p:p + klen]
            p += max(klen, 0)
            vlen, p = read_varint(after, p)
            value = None if vlen < 0 else after[p:p + vlen]
            p += max(vlen, 0)
            nh, p = read_varint(after, p)
            headers: List[Tuple[str, Optional[bytes]]] = []
            for _h in range(nh):
                hklen, p = read_varint(after, p)
                hk = after[p:p + hklen].decode()
                p += hklen
                hvlen, p = read_varint(after, p)
                hv = None if hvlen < 0 else after[p:p + hvlen]
                p += max(hvlen, 0)
                headers.append((hk, hv))
            if p != rec_end:
                raise ValueError("record length mismatch")
            out.append((base_offset + off_delta, base_ts + ts_delta,
                        key, value, headers))
    return out


# ---------------------------------------------------------------------------
# consumer protocol (embedded subscription/assignment formats)
# ---------------------------------------------------------------------------

def encode_subscription(topics: List[str]) -> bytes:
    w = _Writer().int16(0)
    w.array(topics, lambda w, t: w.string(t))
    w.bytes_(None)
    return w.done()


def decode_subscription(data: bytes) -> List[str]:
    r = _Reader(data)
    r.int16()
    topics = r.array(lambda r: r.string())
    return topics


def encode_assignment(parts: Dict[str, List[int]]) -> bytes:
    w = _Writer().int16(0)
    w.array(sorted(parts.items()), lambda w, t: w.string(t[0]).array(
        t[1], lambda w, p: w.int32(p)))
    w.bytes_(None)
    return w.done()


def decode_assignment(data: bytes) -> Dict[str, List[int]]:
    r = _Reader(data)
    r.int16()
    out: Dict[str, List[int]] = {}
    for _ in range(r.int32()):
        topic = r.string()
        out[topic] = r.array(lambda r: r.int32())
    return out


def range_assign(members: List[Tuple[str, List[str]]],
                 partitions: Dict[str, int]) -> Dict[str, Dict[str, List[int]]]:
    """The client-side RangeAssignor the group LEADER runs: per topic,
    contiguous partition ranges to subscribed members in member-id order."""
    out: Dict[str, Dict[str, List[int]]] = {m: {} for m, _ in members}
    for topic, n_parts in sorted(partitions.items()):
        subs = sorted(m for m, topics in members if topic in topics)
        if not subs:
            continue
        per = n_parts // len(subs)
        extra = n_parts % len(subs)
        start = 0
        for i, m in enumerate(subs):
            take = per + (1 if i < extra else 0)
            if take:
                out[m][topic] = list(range(start, start + take))
            start += take
    return out


# ---------------------------------------------------------------------------
# group-aware client
# ---------------------------------------------------------------------------

class KafkaGroupConsumer:
    """The consumer-group dance against any coordinator speaking the group
    APIs: FindCoordinator → JoinGroup → (leader assigns) → SyncGroup →
    Heartbeat / OffsetCommit / OffsetFetch.  One instance = one member."""

    def __init__(self, host: str, port: int, group_id: str,
                 topics: List[str], client_id: str = "flink-tpu",
                 session_timeout_ms: int = 10_000):
        self.group_id = group_id
        self.topics = list(topics)
        self.session_timeout_ms = session_timeout_ms
        self.member_id = ""
        self.generation = -1
        self.assignment: Dict[str, List[int]] = {}
        self._cli = KafkaWireClient(host, port, client_id=client_id)

    # -- raw calls ----------------------------------------------------------
    def find_coordinator(self) -> Tuple[int, str, int]:
        body = _Writer().string(self.group_id).done()
        r = self._cli._call(API_FIND_COORDINATOR, 0, body)
        err = r.int16()
        if err:
            raise ValueError(f"FindCoordinator error {err}")
        return r.int32(), r.string(), r.int32()

    def _join(self) -> Tuple[int, List[Tuple[str, bytes]]]:
        sub = encode_subscription(self.topics)
        body = (_Writer().string(self.group_id)
                .int32(self.session_timeout_ms)
                .string(self.member_id).string("consumer")
                .array([("range", sub)],
                       lambda w, p: w.string(p[0]).bytes_(p[1]))
                .done())
        r = self._cli._call(API_JOIN_GROUP, 0, body)
        err = r.int16()
        if err == ERR_UNKNOWN_MEMBER_ID:
            self.member_id = ""
            raise _Rejoin()
        if err:
            raise ValueError(f"JoinGroup error {err}")
        self.generation = r.int32()
        r.string()                                   # protocol
        leader = r.string()
        self.member_id = r.string()
        members = r.array(lambda r: (r.string(), r.bytes_()))
        return (leader == self.member_id), members

    def _sync(self, assignments: Optional[Dict[str, bytes]]) -> bytes:
        items = sorted((assignments or {}).items())
        body = (_Writer().string(self.group_id).int32(self.generation)
                .string(self.member_id)
                .array(items, lambda w, p: w.string(p[0]).bytes_(p[1]))
                .done())
        r = self._cli._call(API_SYNC_GROUP, 0, body)
        err = r.int16()
        if err in (ERR_REBALANCE_IN_PROGRESS, ERR_ILLEGAL_GENERATION,
                   ERR_UNKNOWN_MEMBER_ID):
            raise _Rejoin()
        if err:
            raise ValueError(f"SyncGroup error {err}")
        return r.bytes_() or b""

    def join(self, max_attempts: int = 10) -> Dict[str, List[int]]:
        """Run the join+sync dance to a stable assignment."""
        for _ in range(max_attempts):
            try:
                is_leader, members = self._join()
                assignments = None
                if is_leader:
                    subs = [(m, decode_subscription(meta))
                            for m, meta in members]
                    n_parts = self._partition_counts()
                    plan = range_assign(subs, n_parts)
                    assignments = {m: encode_assignment(p)
                                   for m, p in plan.items()}
                mine = self._sync(assignments)
                self.assignment = decode_assignment(mine) if mine else {}
                return self.assignment
            except _Rejoin:
                time.sleep(0.05)
                continue
        raise TimeoutError("consumer group join did not stabilize")

    def _partition_counts(self) -> Dict[str, int]:
        meta = self._cli.metadata(self.topics)
        return {t["name"]: len(t["partitions"]) for t in meta["topics"]
                if t["error"] == 0}

    def heartbeat(self) -> bool:
        """True = stable; False = the group is rebalancing, call join()."""
        body = (_Writer().string(self.group_id).int32(self.generation)
                .string(self.member_id).done())
        r = self._cli._call(API_HEARTBEAT, 0, body)
        err = r.int16()
        if err == ERR_NONE:
            return True
        if err in (ERR_REBALANCE_IN_PROGRESS, ERR_ILLEGAL_GENERATION,
                   ERR_UNKNOWN_MEMBER_ID):
            if err == ERR_UNKNOWN_MEMBER_ID:
                self.member_id = ""
            return False
        raise ValueError(f"Heartbeat error {err}")

    def leave(self) -> None:
        body = (_Writer().string(self.group_id)
                .string(self.member_id).done())
        r = self._cli._call(API_LEAVE_GROUP, 0, body)
        r.int16()
        self.assignment = {}

    def commit(self, offsets: Dict[Tuple[str, int], int]) -> None:
        """OffsetCommit v2 under the current generation (fenced: a deposed
        member's commit is rejected by the coordinator)."""
        by_topic: Dict[str, List[Tuple[int, int]]] = {}
        for (topic, part), off in offsets.items():
            by_topic.setdefault(topic, []).append((part, off))
        body = (_Writer().string(self.group_id).int32(self.generation)
                .string(self.member_id).int64(-1)
                .array(sorted(by_topic.items()),
                       lambda w, t: w.string(t[0]).array(
                           sorted(t[1]), lambda w, p: w.int32(p[0])
                           .int64(p[1]).string(None)))
                .done())
        r = self._cli._call(API_OFFSET_COMMIT, 2, body)
        for _ in range(r.int32()):
            r.string()
            for _ in range(r.int32()):
                r.int32()
                err = r.int16()
                if err:
                    raise ValueError(f"OffsetCommit error {err}")

    def committed(self, parts: List[Tuple[str, int]]
                  ) -> Dict[Tuple[str, int], int]:
        """OffsetFetch v1: committed offset per partition (-1 = none)."""
        by_topic: Dict[str, List[int]] = {}
        for topic, part in parts:
            by_topic.setdefault(topic, []).append(part)
        body = (_Writer().string(self.group_id)
                .array(sorted(by_topic.items()),
                       lambda w, t: w.string(t[0]).array(
                           sorted(t[1]), lambda w, p: w.int32(p)))
                .done())
        r = self._cli._call(API_OFFSET_FETCH, 1, body)
        out: Dict[Tuple[str, int], int] = {}
        for _ in range(r.int32()):
            topic = r.string()
            for _ in range(r.int32()):
                part = r.int32()
                off = r.int64()
                r.string()                           # metadata
                err = r.int16()
                if err:
                    raise ValueError(f"OffsetFetch error {err}")
                out[(topic, part)] = off
        return out

    # -- data plane (v2 batches) -------------------------------------------
    def fetch(self, topic: str, partition: int, offset: int,
              max_bytes: int = 1 << 20
              ) -> Tuple[List[DecodedRecord], int]:
        return fetch_v2(self._cli, topic, partition, offset, max_bytes)

    def close(self) -> None:
        self._cli.close()


class _Rejoin(Exception):
    """Internal: the coordinator demands a fresh join."""


# ---------------------------------------------------------------------------
# v2 data-plane calls (usable from the plain wire client too)
# ---------------------------------------------------------------------------

def produce_v2(cli: KafkaWireClient, topic: str, partition: int,
               records: List[Record]) -> int:
    """Produce v3 (message format v2); returns the assigned base offset."""
    batch = encode_record_batch(0, records)
    body = (_Writer().string(None)                   # transactional_id
            .int16(-1).int32(10_000)
            .array([(topic, [(partition, batch)])],
                   lambda w, t: w.string(t[0]).array(
                       t[1], lambda w, p: w.int32(p[0]).bytes_(p[1])))
            .done())
    r = cli._call(0, 3, body)                        # Produce v3
    for _ in range(r.int32()):
        r.string()
        for _ in range(r.int32()):
            r.int32()
            err = r.int16()
            base = r.int64()
            r.int64()                                # log_append_time
            if err:
                raise ValueError(f"produce(v3) error {err}")
            r.int32()                                # throttle_time
            return base
    raise ValueError("empty produce response")


def fetch_v2(cli: KafkaWireClient, topic: str, partition: int, offset: int,
             max_bytes: int = 1 << 20
             ) -> Tuple[List[DecodedRecord], int]:
    """Fetch v4 (record-batch responses) -> (records, high watermark)."""
    body = (_Writer().int32(-1).int32(100).int32(1)
            .int32(max_bytes).int8(0)                # max_bytes, isolation
            .array([(topic, [(partition, offset, max_bytes)])],
                   lambda w, t: w.string(t[0]).array(
                       t[1], lambda w, p: w.int32(p[0]).int64(p[1])
                       .int32(p[2])))
            .done())
    r = cli._call(1, 4, body)                        # Fetch v4
    r.int32()                                        # throttle_time
    for _ in range(r.int32()):
        r.string()
        for _ in range(r.int32()):
            r.int32()
            err = r.int16()
            hw = r.int64()
            r.int64()                                # last_stable_offset
            r.array(lambda r: (r.int64(), r.int64()))  # aborted txns
            data = r.bytes_() or b""
            if err == 1:
                raise IndexError(f"offset {offset} out of range (hw {hw})")
            if err:
                raise ValueError(f"fetch(v4) error {err}")
            return decode_record_batches(data), hw
    raise ValueError("empty fetch response")


class IncrementalFetcher:
    """KIP-227 incremental fetch session (fetch v7): the FIRST poll is a
    full fetch establishing a broker-side session; every later poll sends
    only partitions whose fetch offset CHANGED since the last request,
    and the broker answers with only partitions carrying news — the
    steady-state idle poll is a near-empty exchange.

    ``poll() -> {partition: [DecodedRecord, ...]}``; offsets advance
    automatically as records are returned.  Per-partition errors do NOT
    raise (the healthy partitions' records would be lost): the errored
    partition lands in ``partition_errors``, leaves the local offset map,
    and is forgotten from the broker session on the next request —
    callers inspect ``partition_errors`` and re-add with a corrected
    offset."""

    def __init__(self, cli: KafkaWireClient, topic: str,
                 partitions: List[int], start_offsets=None,
                 max_bytes: int = 1 << 20):
        self.cli = cli
        self.topic = topic
        self.max_bytes = max_bytes
        self.offsets: Dict[int, int] = {
            p: (start_offsets or {}).get(p, 0) for p in partitions}
        self.session_id = 0
        self.epoch = 0
        self._sent: Dict[int, int] = {}       # offsets as of last request
        self._forget: List[int] = []          # drop from the session
        self.partition_errors: Dict[int, int] = {}

    def _request(self, parts: List[int], forget: List[int]) -> '_Reader':
        from flink_tpu_torch.connectors.kafka import _API_FETCH
        body = (_Writer().int32(-1).int32(100).int32(1)
                .int32(self.max_bytes).int8(0)
                .int32(self.session_id).int32(self.epoch)
                .array([(self.topic,
                         [(p, self.offsets[p]) for p in parts])],
                       lambda w, t: w.string(t[0]).array(
                           t[1], lambda w, pp: w.int32(pp[0])
                           .int64(pp[1]).int64(0).int32(self.max_bytes)))
                .array([(self.topic, list(forget))] if forget else [],
                       lambda w, t: w.string(t[0]).array(
                           t[1], lambda w, p: w.int32(p))))
        return self.cli._call(_API_FETCH, 7, body.done())

    def poll(self) -> Dict[int, List[DecodedRecord]]:
        from flink_tpu_torch.connectors.kafka import (
            _ERR_FETCH_SESSION_ID_NOT_FOUND,
            _ERR_INVALID_FETCH_SESSION_EPOCH)
        self.partition_errors = {}
        if self.epoch == 0:
            parts = sorted(self.offsets)         # full fetch
        else:
            parts = sorted(p for p, o in self.offsets.items()
                           if self._sent.get(p) != o)
        forget, self._forget = self._forget, []
        r = self._request(parts, forget)
        r.int32()                                # throttle
        err = r.int16()
        sid = r.int32()
        if err in (_ERR_FETCH_SESSION_ID_NOT_FOUND,
                   _ERR_INVALID_FETCH_SESSION_EPOCH):
            self.session_id, self.epoch = 0, 0   # re-establish full
            self._sent = {}
            return self.poll()
        if err:
            raise ValueError(f"fetch(v7) error {err}")
        if self.epoch == 0 and sid:
            self.session_id = sid
        self.epoch += 1
        for p in parts:
            self._sent[p] = self.offsets[p]
        out: Dict[int, List[DecodedRecord]] = {}
        for _ in range(r.int32()):
            r.string()
            for _ in range(r.int32()):
                part = r.int32()
                perr = r.int16()
                r.int64()                        # high watermark
                r.int64()                        # last_stable_offset
                r.int64()                        # log_start_offset
                r.array(lambda r: (r.int64(), r.int64()))  # aborted
                data = r.bytes_() or b""
                if perr:
                    # healthy partitions keep flowing; the bad one exits
                    # the session until the caller re-adds it
                    self.partition_errors[part] = perr
                    self.offsets.pop(part, None)
                    self._sent.pop(part, None)
                    self._forget.append(part)
                    continue
                recs = decode_record_batches(data)
                if recs:
                    out[part] = recs
                    self.offsets[part] = recs[-1][0] + 1
        return out

    def add_partition(self, partition: int, offset: int) -> None:
        """(Re-)track a partition (e.g. after a partition_errors entry)."""
        self.offsets[partition] = offset


# ---------------------------------------------------------------------------
# group source (committed-offset restart)
# ---------------------------------------------------------------------------

class KafkaGroupSource:
    """Source with committed-offset restart — the reference KafkaSource's
    exact model (``KafkaSource.java:1``): partitions are assigned
    MANUALLY (split ``i`` owns partitions ``p % parallelism == i``, the
    enumerator's round-robin), while ``group_id`` is used only for
    OffsetFetch/OffsetCommit — the ``OffsetsInitializer.committedOffsets``
    behaviour.  The reference deliberately avoids group-membership
    assignment for its readers (a mid-read rebalance would yank partitions
    from a running split); :class:`KafkaGroupConsumer` provides the full
    membership dance for clients that want it.

    Each split reads its partitions from the committed offset (earliest
    when none) to the high watermark at start, committing as it goes, so a
    restarted job resumes where the last run's commits left off."""

    bounded = True

    def __init__(self, host: str, port: int, topic: str, group_id: str,
                 timestamp_column: Optional[str] = None,
                 batch_rows: int = 1024, commit_every_rows: int = 4096):
        self.host, self.port = host, port
        self.topic = topic
        self.group_id = group_id
        self.timestamp_column = timestamp_column
        self.batch_rows = batch_rows
        self.commit_every_rows = commit_every_rows

    def create_splits(self, parallelism: int):
        from flink_tpu_torch.connectors.sources import SourceSplit

        n = max(1, parallelism)

        class _Split(SourceSplit):
            def split_id(_self) -> str:
                return f"{self.topic}@{self.group_id}-{_self.index}"

            def read(_self):
                return self._read_split(_self.index, _self.of)

        return [_Split(self, i, n) for i in range(n)]

    def _read_split(self, index: int, of: int) -> Iterator[Any]:
        import json

        from flink_tpu_torch.core.batch import RecordBatch

        c = KafkaGroupConsumer(self.host, self.port, self.group_id,
                               [self.topic], client_id=f"split-{index}")
        try:
            n_parts = c._partition_counts().get(self.topic, 0)
            parts = [p for p in range(n_parts) if p % of == index]
            if not parts:
                return
            committed = c.committed([(self.topic, p) for p in parts])
            positions = {p: max(committed.get((self.topic, p), -1) + 1, 0)
                         for p in parts}
            ends = {p: c._cli.latest_offset(self.topic, p) for p in parts}
            rows: List[dict] = []
            since_commit = 0
            for p in parts:
                while positions[p] < ends[p]:
                    recs, _hw = c.fetch(self.topic, p, positions[p])
                    if not recs:
                        break
                    for off, _ts, _k, v, _h in recs:
                        if off >= ends[p]:
                            break
                        positions[p] = off + 1
                        since_commit += 1
                        if v is not None:
                            rows.append(json.loads(v.decode()))
                    while len(rows) >= self.batch_rows:
                        chunk = rows[:self.batch_rows]
                        rows = rows[self.batch_rows:]
                        yield self._batch(chunk, RecordBatch)
                    if since_commit >= self.commit_every_rows:
                        c.commit({(self.topic, q): positions[q] - 1
                                  for q in parts if positions[q] > 0})
                        since_commit = 0
            if rows:
                yield self._batch(rows, RecordBatch)
            # final commit: the next run resumes after everything read
            # (generation -1 + empty member = the simple-client commit path)
            c.commit({(self.topic, q): positions[q] - 1
                      for q in parts if positions[q] > 0})
        finally:
            c.close()

    def _batch(self, rows, RecordBatch):
        cols = {k: np.asarray([r[k] for r in rows]) for k in rows[0]}
        if self.timestamp_column is not None:
            ts = np.asarray(cols[self.timestamp_column], np.int64)
            return RecordBatch(cols, timestamps=ts)
        return RecordBatch(cols)

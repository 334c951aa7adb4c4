"""Hadoop SequenceFile format (version 6, record-oriented).

The port's copy of ``flink_tpu/formats/sequencefile.py``: host Python as
JAX's, the same bytes on the wire and on disk, so a file either package
writes reads in the other.

Analog of the reference's sequence-file support
(``flink-formats/flink-sequence-file``): the Hadoop container header
(``SEQ`` magic + version, key/value class names as Hadoop Text, the
compression flags, a metadata Text map, a 16-byte sync marker), followed
by records framed as ``record-length, key-length, key bytes, value
bytes`` with periodic ``-1 + sync`` resynchronization points — the
layout HDFS-era tooling (Hive external tables, MapReduce inputs) reads.

Scope: uncompressed record format with ``org.apache.hadoop.io.Text``
keys and values.  Rows serialize as ``key = <key column text>``,
``value = JSON of the remaining columns`` — the
``SequenceFileWriterFactory<Text, Text>`` shape.  Block compression and
other Writable classes are not implemented.
"""

from __future__ import annotations

import io
import json
import os
import struct
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from flink_tpu_torch.core.batch import RecordBatch

MAGIC = b"SEQ"
VERSION = 6
TEXT = b"org.apache.hadoop.io.Text"
_SYNC_INTERVAL = 2000   # bytes between sync markers, like Hadoop's


def _write_vint(out: io.BytesIO, n: int) -> None:
    """Hadoop WritableUtils.writeVInt (zero-compressed)."""
    if -112 <= n <= 127:
        out.write(struct.pack("b", n))
        return
    length = -112
    if n < 0:
        n ^= -1
        length = -120
    tmp = n
    while tmp:
        tmp >>= 8
        length -= 1
    out.write(struct.pack("b", length))
    size = (-length) - 112 if length >= -120 else (-length) - 120
    for i in range(size - 1, -1, -1):
        out.write(struct.pack("B", (n >> (8 * i)) & 0xFF))


def _read_vint(f) -> int:
    (first,) = struct.unpack("b", f.read(1))
    if first >= -112:
        return first
    negative = first < -120
    size = (-first) - 120 if negative else (-first) - 112
    n = 0
    for _ in range(size):
        n = (n << 8) | f.read(1)[0]
    return (n ^ -1) if negative else n


def _text(b: bytes) -> bytes:
    out = io.BytesIO()
    _write_vint(out, len(b))
    out.write(b)
    return out.getvalue()


def _read_text(f) -> bytes:
    n = _read_vint(f)
    return f.read(n)


def write_sequencefile(batches, path: str,
                       key_column: Optional[str] = None) -> int:
    """Drain batches into a SequenceFile; ``key_column`` becomes the Text
    key (empty when None), every column JSON-serializes into the Text
    value.  Returns rows written."""
    from flink_tpu_torch.connectors.util import json_default

    sync = os.urandom(16)
    n = 0
    with open(path, "wb") as f:
        f.write(MAGIC + bytes([VERSION]))
        f.write(_text(TEXT))                 # key class
        f.write(_text(TEXT))                 # value class
        f.write(b"\x00\x00")                 # no value/block compression
        f.write(struct.pack(">i", 0))        # empty metadata map
        f.write(sync)
        since_sync = 0
        for b in batches:
            for row in b.to_rows():
                key = (b"" if key_column is None
                       else str(row[key_column]).encode())
                val = json.dumps(row, default=json_default).encode()
                krec = _text(key)
                vrec = _text(val)
                if since_sync >= _SYNC_INTERVAL:
                    f.write(struct.pack(">i", -1) + sync)
                    since_sync = 0
                rec = struct.pack(">ii", len(krec) + len(vrec),
                                  len(krec)) + krec + vrec
                f.write(rec)
                since_sync += len(rec)
                n += 1
    return n


def read_sequencefile(path: str, batch_size: int = 8192,
                      timestamp_column: Optional[str] = None,
                      skip_rows: int = 0) -> Iterator[RecordBatch]:
    """SequenceFile -> RecordBatch iterator.  Text values parse as JSON
    rows when possible; otherwise each record yields
    ``{"key": <str>, "value": <str>}`` (foreign files with plain text
    payloads stay readable)."""
    from flink_tpu_torch.connectors.util import rows_to_batch

    with open(path, "rb") as f:
        hdr = f.read(4)
        if len(hdr) < 4 or hdr[:3] != MAGIC:
            raise ValueError("not a SequenceFile (bad magic)")
        if hdr[3] != VERSION:
            raise ValueError(f"unsupported SequenceFile version {hdr[3]}")
        key_cls = _read_text(f)
        val_cls = _read_text(f)
        if key_cls != TEXT or val_cls != TEXT:
            raise ValueError(
                f"unsupported Writable classes {key_cls!r}/{val_cls!r} "
                f"(Text/Text only)")
        comp, block = f.read(2)
        if comp or block:
            raise ValueError("compressed SequenceFiles are not supported")
        (nmeta,) = struct.unpack(">i", f.read(4))
        for _ in range(nmeta):
            _read_text(f)
            _read_text(f)
        sync = f.read(16)
        rows: List[dict] = []
        seen = 0
        while True:
            lenb = f.read(4)
            if len(lenb) < 4:
                break
            (rec_len,) = struct.unpack(">i", lenb)
            if rec_len == -1:                  # sync marker
                got = f.read(16)
                if len(got) < 16:
                    break                      # torn tail inside the sync
                if got != sync:
                    raise ValueError("sync marker mismatch (corrupt file)")
                continue
            if rec_len < 0:
                raise ValueError(f"corrupt record length {rec_len}")
            klenb = f.read(4)
            if len(klenb) < 4:
                break                          # torn tail: keep the prefix
            (key_len,) = struct.unpack(">i", klenb)
            if not 0 <= key_len <= rec_len:
                raise ValueError(f"corrupt key length {key_len} "
                                 f"(record {rec_len})")
            kv = f.read(rec_len)
            if len(kv) < rec_len:
                break                          # torn tail record
            kbuf = io.BytesIO(kv[:key_len])
            vbuf = io.BytesIO(kv[key_len:])
            key = _read_text(kbuf).decode()
            val = _read_text(vbuf).decode()
            seen += 1
            if seen <= skip_rows:
                continue
            try:
                row = json.loads(val)
                if not isinstance(row, dict):
                    raise ValueError
                if key:
                    # the record KEY is data too — a foreign file may keep
                    # meaning only there; never silently drop it (when the
                    # value already owns "key", park it next door)
                    row["key" if "key" not in row else "_seq_key"] = key
            except ValueError:
                row = {"key": key, "value": val}
            rows.append(row)
            if len(rows) >= batch_size:
                yield rows_to_batch(rows, timestamp_column)
                rows = []
        if rows:
            yield rows_to_batch(rows, timestamp_column)

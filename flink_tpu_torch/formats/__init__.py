"""Record formats: CSV, JSON-lines, FTB binary, Avro, Parquet, ORC and
SequenceFile (the port's copy of ``flink_tpu/formats/__init__.py``).

Analog of ``flink-formats/*`` (Avro/Parquet/ORC/CSV/JSON): encoders/decoders
between files and columnar ``RecordBatch``es.  Columnar-first: a format reads
a whole batch of rows into typed numpy columns (the batched-boundary pattern
the TPU runtime needs), never record-at-a-time objects.

FTB is the framework's own binary format (``native/codec.py``):
length-prefixed compressed column blocks in CRC-checked frames, byte for
byte the JAX package's, so a file one package writes reads in the other.
Avro (``formats/avro.py``), Parquet (``formats/parquet.py``), ORC
(``formats/orc.py``) and SequenceFile (``formats/sequencefile.py``) are
implemented from their specs in host Python, as JAX's are: no
fastavro/pyarrow, and the same bytes from the same batches.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np

from flink_tpu_torch.core.batch import RecordBatch


def _coerce_columns(rows: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Rows -> typed columns: all-int values -> int64, all-bool -> bool,
    numeric-with-floats/None -> float64 (None becomes NaN), anything
    mixed -> object.  Column set = union over all rows.  int64 is only
    chosen when EVERY value is an integer — ``np.asarray([1.5], int64)``
    silently truncates, so a try-int-first ladder would corrupt float
    columns."""
    if not rows:
        return {}
    names: Dict[str, None] = {}
    for r in rows:
        for k in r:
            names.setdefault(k)
    cols: Dict[str, np.ndarray] = {}
    for name in names:
        vals = [r.get(name) for r in rows]
        if all(isinstance(v, bool) for v in vals):
            cols[name] = np.asarray(vals, bool)
            continue
        if all(isinstance(v, (int, np.integer))
               and not isinstance(v, bool) for v in vals):
            try:
                cols[name] = np.asarray(vals, np.int64)
                continue
            except OverflowError:
                pass                    # beyond int64: fall through
        try:
            cols[name] = np.asarray(vals, np.float64)
        except (ValueError, TypeError, OverflowError):
            cols[name] = np.asarray(vals, object)
    return cols


# ---------------------------------------------------------------------------
# CSV
# ---------------------------------------------------------------------------

def read_csv(path: str, batch_size: int = 8192, delimiter: str = ",",
             timestamp_column: Optional[str] = None,
             skip_rows: int = 0) -> Iterator[RecordBatch]:
    """CSV file -> RecordBatch iterator with type inference per batch.
    ``skip_rows`` skips *data* rows (resume position), not the header."""
    import csv as _csv

    with open(path, newline="") as f:
        reader = _csv.DictReader(f, delimiter=delimiter)
        buf: List[Dict[str, Any]] = []
        for i, row in enumerate(reader):
            if i < skip_rows:
                continue
            buf.append(row)
            if len(buf) >= batch_size:
                yield _batch_from_rows(buf, timestamp_column)
                buf = []
        if buf:
            yield _batch_from_rows(buf, timestamp_column)


def write_csv(batches, path: str, delimiter: str = ",") -> int:
    import csv as _csv

    n = 0
    writer = None
    with open(path, "w", newline="") as f:
        for b in batches:
            for row in b.to_rows():
                if writer is None:
                    writer = _csv.DictWriter(f, fieldnames=list(row.keys()),
                                             delimiter=delimiter)
                    writer.writeheader()
                writer.writerow(row)
                n += 1
    return n


# ---------------------------------------------------------------------------
# JSON lines
# ---------------------------------------------------------------------------

def read_jsonl(path: str, batch_size: int = 8192,
               timestamp_column: Optional[str] = None,
               skip_rows: int = 0) -> Iterator[RecordBatch]:
    with open(path) as f:
        buf: List[Dict[str, Any]] = []
        data_row = 0  # skip_rows counts DATA rows (matches reader positions)
        for line in f:
            if not line.strip():
                continue
            data_row += 1
            if data_row <= skip_rows:
                continue
            buf.append(json.loads(line))
            if len(buf) >= batch_size:
                yield _batch_from_rows(buf, timestamp_column)
                buf = []
        if buf:
            yield _batch_from_rows(buf, timestamp_column)


def write_jsonl(batches, path: str) -> int:
    n = 0
    with open(path, "w") as f:
        for b in batches:
            for row in b.to_rows():
                f.write(json.dumps(row, default=_json_default) + "\n")
                n += 1
    return n


def _json_default(o):
    from flink_tpu_torch.connectors.util import json_default
    return json_default(o)


def _batch_from_rows(rows: List[Dict[str, Any]],
                     timestamp_column: Optional[str]) -> RecordBatch:
    cols = _coerce_columns(rows)
    ts = (np.asarray(cols[timestamp_column], np.int64)
          if timestamp_column and timestamp_column in cols else None)
    return RecordBatch(cols, timestamps=ts)


# ---------------------------------------------------------------------------
# FTB binary (length-prefixed encoded RecordBatches; CRC-checked frames)
# ---------------------------------------------------------------------------

_FRAME = struct.Struct("<II")  # payload_len, crc32


def write_frame(fileobj, payload: bytes) -> None:
    """One CRC-checked length-prefixed frame (shared by FTB files and the
    partitioned-log connector — single source of truth for the framing)."""
    from flink_tpu_torch.native import crc32

    fileobj.write(_FRAME.pack(len(payload), crc32(payload)))
    fileobj.write(payload)


def read_frames(path: str, start_offset: int = 0):
    """Yield ``(payload, next_offset)`` per complete frame; stops cleanly at
    a torn tail write; raises on CRC mismatch."""
    from flink_tpu_torch.native import crc32

    with open(path, "rb") as f:
        if start_offset:
            f.seek(start_offset)
        while True:
            hdr = f.read(_FRAME.size)
            if len(hdr) < _FRAME.size:
                return
            ln, crc = _FRAME.unpack(hdr)
            payload = f.read(ln)
            if len(payload) < ln:
                return  # torn tail write: stop at last complete frame
            if crc32(payload) != crc:
                raise IOError(f"frame CRC mismatch in {path}")
            yield payload, f.tell()


def iter_frames(data: bytes):
    """Yield frame payloads from an in-memory buffer (wire fetch bodies)."""
    from flink_tpu_torch.native import crc32

    off = 0
    while off + _FRAME.size <= len(data):
        ln, crc = _FRAME.unpack_from(data, off)
        start = off + _FRAME.size
        if start + ln > len(data):
            return
        payload = data[start:start + ln]
        if crc32(payload) != crc:
            raise IOError("frame CRC mismatch in buffer")
        yield payload
        off = start + ln


def frame_span(data: bytes) -> int:
    """Byte length of the WHOLE frames at the head of ``data`` (a fetch
    response must never split a frame)."""
    off = 0
    while off + _FRAME.size <= len(data):
        ln, _ = _FRAME.unpack_from(data, off)
        if off + _FRAME.size + ln > len(data):
            break
        off += _FRAME.size + ln
    return off


def write_ftb(batches, path: str, compress: bool = True,
              append: bool = False) -> int:
    from flink_tpu_torch.native.codec import encode_batch

    n = 0
    with open(path, "ab" if append else "wb") as f:
        for b in batches:
            write_frame(f, encode_batch(b, compress=compress))
            n += len(b)
    return n


def read_ftb(path: str, skip_batches: int = 0,
             start_offset: int = 0) -> Iterator[RecordBatch]:
    from flink_tpu_torch.native.codec import decode_batch

    for i, (payload, _off) in enumerate(read_frames(path, start_offset)):
        if i >= skip_batches:
            yield decode_batch(payload)


def _read_avro(path: str, batch_size: int = 8192, **kw):
    from flink_tpu_torch.formats.avro import read_avro
    return read_avro(path, batch_size=batch_size)


def _write_avro(batches, path: str, **kw) -> int:
    from flink_tpu_torch.formats.avro import write_avro
    return write_avro(batches, path, **kw)


def _read_parquet(path: str, batch_size: int = 0, **kw):
    from flink_tpu_torch.formats.parquet import read_parquet
    return read_parquet(path, batch_size=batch_size, **kw)


def _write_parquet(batches, path: str, **kw) -> int:
    from flink_tpu_torch.formats.parquet import write_parquet
    return write_parquet(batches, path, **kw)


def _read_orc(path: str, batch_size: int = 0, **kw):
    from flink_tpu_torch.formats.orc import read_orc
    return read_orc(path, batch_size=batch_size, **kw)


def _write_orc(batches, path: str, **kw) -> int:
    from flink_tpu_torch.formats.orc import write_orc
    return write_orc(batches, path, **kw)


def _read_seq(path: str, batch_size: int = 8192, **kw):
    from flink_tpu_torch.formats.sequencefile import read_sequencefile
    return read_sequencefile(path, batch_size=batch_size, **kw)


def _write_seq(batches, path: str, **kw) -> int:
    from flink_tpu_torch.formats.sequencefile import write_sequencefile
    return write_sequencefile(batches, path, **kw)


FORMATS = {
    "csv": (read_csv, write_csv),
    "jsonl": (read_jsonl, write_jsonl),
    "ftb": (read_ftb, write_ftb),
    "avro": (_read_avro, _write_avro),
    "parquet": (_read_parquet, _write_parquet),
    "orc": (_read_orc, _write_orc),
    "seq": (_read_seq, _write_seq),
}


def reader_for(fmt: str):
    if fmt not in FORMATS:
        raise ValueError(f"unknown format {fmt!r}; have {sorted(FORMATS)}")
    return FORMATS[fmt][0]


def writer_for(fmt: str):
    if fmt not in FORMATS:
        raise ValueError(f"unknown format {fmt!r}; have {sorted(FORMATS)}")
    return FORMATS[fmt][1]

"""Avro Object Container Files, pure Python — no fastavro/pyarrow needed.

The port's copy of ``flink_tpu/formats/avro.py``: host Python as JAX's, the
same bytes on the wire and on disk, so a file either package writes reads
in the other.

Analog of the reference's ``flink-formats/flink-avro`` (``AvroInputFormat``/
``AvroWriterFactory``): reads and writes the Avro 1.11 object container
format (magic ``Obj\\x01``, file metadata map with embedded JSON schema,
sync-marker-delimited blocks) for RECORD schemas over the scalar types the
columnar runtime uses: null, boolean, int, long, float, double, string,
bytes, and nullable unions thereof.  Deflate codec supported (zlib);
snappy is not (not in the stdlib), matching the gated-dependency policy.

The columnar bridge mirrors the repo's other formats: ``read_avro`` yields
``RecordBatch``es; ``write_avro`` drains batches into one container file,
deriving the schema from the first batch's dtypes unless one is given.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.core.batch import RecordBatch

_MAGIC = b"Obj\x01"


# ---------------------------------------------------------------------------
# primitive codecs (Avro binary encoding)
# ---------------------------------------------------------------------------

def _zigzag_encode(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _zigzag_decode(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def write_long(buf: io.BytesIO, n: int) -> None:
    n = _zigzag_encode(int(n))
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.write(bytes([b | 0x80]))
        else:
            buf.write(bytes([b]))
            return


def read_long(buf) -> int:
    shift = 0
    acc = 0
    while True:
        (b,) = buf.read(1)
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            return _zigzag_decode(acc)
        shift += 7


def write_bytes(buf: io.BytesIO, data: bytes) -> None:
    write_long(buf, len(data))
    buf.write(data)


def read_bytes(buf) -> bytes:
    return buf.read(read_long(buf))


def write_string(buf: io.BytesIO, s: str) -> None:
    write_bytes(buf, s.encode("utf-8"))


def read_string(buf) -> str:
    return read_bytes(buf).decode("utf-8")


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------

_DTYPE_TO_AVRO = [
    (np.bool_, "boolean"),
    (np.int32, "int"),
    (np.int64, "long"),
    (np.float32, "float"),
    (np.float64, "double"),
]

_AVRO_TO_DTYPE = {"boolean": np.bool_, "int": np.int32, "long": np.int64,
                  "float": np.float32, "double": np.float64,
                  "string": object, "bytes": object, "null": object}


def schema_for_columns(columns: Dict[str, np.ndarray],
                       name: str = "Record") -> Dict[str, Any]:
    """Derive a RECORD schema from a batch's column dtypes."""
    fields = []
    for cname, arr in columns.items():
        arr = np.asarray(arr)
        avro_t: Any = None
        for dt, t in _DTYPE_TO_AVRO:
            if arr.dtype == np.dtype(dt):
                avro_t = t
                break
        if avro_t is None and np.issubdtype(arr.dtype, np.integer):
            avro_t = "long"
        if avro_t is None and np.issubdtype(arr.dtype, np.floating):
            avro_t = "double"
        if avro_t is None:
            # object column: string, nullable when any None present
            has_none = any(v is None for v in arr.tolist())
            avro_t = ["null", "string"] if has_none else "string"
        fields.append({"name": cname, "type": avro_t})
    return {"type": "record", "name": name, "fields": fields}


def _field_type(t: Any) -> Tuple[str, bool]:
    """-> (base primitive, nullable)."""
    if isinstance(t, list):
        non_null = [x for x in t if x != "null"]
        if len(non_null) != 1:
            raise ValueError(f"unsupported union {t!r} (one non-null branch)")
        base, _ = _field_type(non_null[0])
        return base, True
    if isinstance(t, dict):
        return _field_type(t.get("type"))
    if t in _AVRO_TO_DTYPE:
        return t, False
    raise ValueError(f"unsupported Avro type {t!r} (scalar records only)")


# ---------------------------------------------------------------------------
# datum encoding
# ---------------------------------------------------------------------------

def _encode_value(buf: io.BytesIO, base: str, nullable: bool, v: Any) -> None:
    if nullable:
        if v is None or (isinstance(v, float) and np.isnan(v)
                         and base in ("string", "bytes")):
            write_long(buf, 0)   # union branch: null
            return
        write_long(buf, 1)
    elif v is None:
        # schema was derived non-nullable (e.g. from a first batch without
        # nulls): refusing beats silently writing the string "None"
        raise ValueError(
            "null value in a non-nullable Avro field — pass an explicit "
            "schema with a ['null', ...] union for this column")
    if base == "boolean":
        buf.write(b"\x01" if v else b"\x00")
    elif base in ("int", "long"):
        write_long(buf, int(v))
    elif base == "float":
        buf.write(struct.pack("<f", float(v)))
    elif base == "double":
        buf.write(struct.pack("<d", float(v)))
    elif base == "string":
        write_string(buf, str(v))
    elif base == "bytes":
        write_bytes(buf, bytes(v))
    elif base == "null":
        pass
    else:
        raise ValueError(f"unsupported type {base}")


def _decode_value(buf, base: str, nullable: bool) -> Any:
    if nullable:
        if read_long(buf) == 0:
            return None
    if base == "boolean":
        return buf.read(1) == b"\x01"
    if base in ("int", "long"):
        return read_long(buf)
    if base == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if base == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if base == "string":
        return read_string(buf)
    if base == "bytes":
        return read_bytes(buf)
    if base == "null":
        return None
    raise ValueError(f"unsupported type {base}")


# ---------------------------------------------------------------------------
# container file
# ---------------------------------------------------------------------------

def write_avro(batches: Iterable[RecordBatch], path: str,
               schema: Optional[Dict[str, Any]] = None,
               codec: str = "deflate") -> int:
    """Write batches into one Avro object container file; returns rows
    written.  ``codec``: 'null' or 'deflate'."""
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported codec {codec!r} (null/deflate)")
    sync = os.urandom(16)
    total = 0
    f = open(path, "wb")
    try:
        wrote_header = False
        fields: List[Tuple[str, str, bool]] = []
        for batch in batches:
            if len(batch) == 0:
                continue
            if not wrote_header:
                if schema is None:
                    schema = schema_for_columns(batch.columns)
                fields = [(fd["name"], *_field_type(fd["type"]))
                          for fd in schema["fields"]]
                hdr = io.BytesIO()
                hdr.write(_MAGIC)
                meta = {"avro.schema": json.dumps(schema).encode(),
                        "avro.codec": codec.encode()}
                write_long(hdr, len(meta))
                for k, v in meta.items():
                    write_string(hdr, k)
                    write_bytes(hdr, v)
                write_long(hdr, 0)  # end of metadata map
                hdr.write(sync)
                f.write(hdr.getvalue())
                wrote_header = True
            cols = {n: np.asarray(batch.columns[n]).tolist()
                    for n, _, _ in fields}
            blk = io.BytesIO()
            n_rows = len(batch)
            for i in range(n_rows):
                for name, base, nullable in fields:
                    _encode_value(blk, base, nullable, cols[name][i])
            payload = blk.getvalue()
            if codec == "deflate":
                payload = zlib.compress(payload)[2:-4]  # raw deflate
            out = io.BytesIO()
            write_long(out, n_rows)
            write_bytes(out, payload)
            out.write(sync)
            f.write(out.getvalue())
            total += n_rows
        if not wrote_header:
            # empty input: still a valid container (schema required)
            if schema is None:
                schema = {"type": "record", "name": "Record", "fields": []}
            hdr = io.BytesIO()
            hdr.write(_MAGIC)
            meta = {"avro.schema": json.dumps(schema).encode(),
                    "avro.codec": codec.encode()}
            write_long(hdr, len(meta))
            for k, v in meta.items():
                write_string(hdr, k)
                write_bytes(hdr, v)
            write_long(hdr, 0)
            hdr.write(sync)
            f.write(hdr.getvalue())
    finally:
        f.close()
    return total


def read_avro(path: str, batch_size: int = 8192):
    """Yield ``RecordBatch``es from an Avro object container file,
    streaming block by block (sync markers self-delimit blocks, so memory
    stays bounded by one block + the pending batch)."""
    with open(path, "rb") as f:
        if f.read(4) != _MAGIC:
            raise ValueError(f"{path}: not an Avro object container file")
        meta: Dict[str, bytes] = {}
        n = read_long(f)
        while n != 0:
            if n < 0:  # negative count: size precedes (spec allows)
                read_long(f)
                n = -n
            for _ in range(n):
                k = read_string(f)
                meta[k] = read_bytes(f)
            n = read_long(f)
        schema = json.loads(meta["avro.schema"].decode())
        codec = meta.get("avro.codec", b"null").decode()
        if codec not in ("null", "deflate"):
            raise ValueError(f"unsupported codec {codec!r}")
        sync = f.read(16)
        fields = [(fd["name"], *_field_type(fd["type"]))
                  for fd in schema.get("fields", [])]

        pending: List[Dict[str, Any]] = []
        while True:
            head = f.read(1)
            if not head:
                break
            f.seek(-1, io.SEEK_CUR)
            n_rows = read_long(f)
            payload = read_bytes(f)
            if f.read(16) != sync:
                raise ValueError(
                    f"{path}: sync marker mismatch (corrupt block)")
            if codec == "deflate":
                payload = zlib.decompress(payload, wbits=-15)
            blk = io.BytesIO(payload)
            for _ in range(n_rows):
                row = {name: _decode_value(blk, base, nullable)
                       for name, base, nullable in fields}
                pending.append(row)
                if len(pending) >= batch_size:
                    yield _rows_to_batch(pending, fields)
                    pending = []
        if pending:
            yield _rows_to_batch(pending, fields)


def _rows_to_batch(rows: List[Dict[str, Any]],
                   fields: List[Tuple[str, str, bool]]) -> RecordBatch:
    cols: Dict[str, np.ndarray] = {}
    for name, base, nullable in fields:
        vals = [r[name] for r in rows]
        if nullable and any(v is None for v in vals):
            arr = np.empty(len(vals), object)
            arr[:] = vals
        else:
            arr = np.asarray(vals, dtype=_AVRO_TO_DTYPE.get(base, object))
        cols[name] = arr
    return RecordBatch(cols)

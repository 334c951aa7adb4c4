"""ORC, pure Python from the spec — no pyarrow needed.

The port's copy of ``flink_tpu/formats/orc.py``: host Python as JAX's, the
same bytes on the wire and on disk, so a file either package writes reads
in the other.

Analog of the reference's ``flink-formats/flink-orc``
(``OrcColumnarRowSplitReader``/``OrcBulkWriterFactory``); this
environment has no pyarrow, so the format is implemented from first
principles the same way ``avro.py`` and ``parquet.py`` were:

- **File layout**: ``ORC`` magic, stripes (data streams + a protobuf
  stripe footer), file footer (types, stripe directory, row count),
  postscript (footer length, compression kind), one trailing byte with
  the postscript length.
- **Protobuf**: a minimal encoder/decoder (varints, length-delimited
  fields) covers the orc_proto messages used: PostScript, Footer,
  StripeInformation, Type, StripeFooter, Stream, ColumnEncoding.
- **Types**: BOOLEAN (bit-packed byte-RLE), INT/LONG (int RLE),
  FLOAT/DOUBLE (IEEE little-endian), STRING (DATA + LENGTH streams).
  Columns are flat and non-null on write (the columnar runtime carries
  no nulls); PRESENT streams are honored on read.
- **Integer encodings**: the writer emits DIRECT (RLEv1 — runs with a
  signed delta byte, literal groups of varints, legal per the spec's
  per-column ColumnEncoding); the reader handles DIRECT **and**
  DIRECT_V2 (all four RLEv2 sub-encodings: short-repeat, direct, delta,
  patched-base — validated against the spec's worked byte examples) plus
  DICTIONARY_V2 strings, so files from modern writers read back.
- **Compression**: NONE or ZLIB (raw-deflate chunks behind the 3-byte
  ``length*2+isOriginal`` headers), per the gated-dependency policy.

``read_orc`` yields one RecordBatch per stripe; ``write_orc`` drains
batches into stripes.  Interop caveat (PARITY.md): validated against
spec-derived golden bytes and round-trips, not against a foreign
implementation — none exists in this image.
"""

from __future__ import annotations

import struct
import zlib
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.core.batch import RecordBatch

MAGIC = b"ORC"

# orc_proto enums
K_BOOLEAN, K_BYTE, K_SHORT, K_INT, K_LONG = 0, 1, 2, 3, 4
K_FLOAT, K_DOUBLE, K_STRING, K_BINARY = 5, 6, 7, 8
K_TIMESTAMP, K_DECIMAL = 9, 14
K_STRUCT = 12
#: timestamp values are seconds relative to the ORC epoch 2015-01-01
#: 00:00:00 UTC, plus a scaled-nanosecond SECONDARY stream
_ORC_EPOCH_S = 1_420_070_400
COMP_NONE, COMP_ZLIB = 0, 1
STREAM_PRESENT, STREAM_DATA, STREAM_LENGTH = 0, 1, 2
STREAM_DICT_DATA = 3
STREAM_SECONDARY = 5
ENC_DIRECT, ENC_DICTIONARY, ENC_DIRECT_V2, ENC_DICTIONARY_V2 = 0, 1, 2, 3

#: RLEv2 5-bit width codes -> bit widths (FixedBitSizes of the spec)
_V2_WIDTHS = list(range(1, 25)) + [26, 28, 30, 32, 40, 48, 56, 64]


# ---------------------------------------------------------------------------
# protobuf primitives
# ---------------------------------------------------------------------------

def _uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _svarint(n: int) -> bytes:
    """Zigzag-encoded signed varint."""
    return _uvarint((n << 1) ^ (n >> 63) if n < 0 else n << 1)


def _read_uvarint(data, pos: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


def _unzig(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


class _Msg:
    """Protobuf message writer (wire types 0 varint / 2 bytes only —
    the ORC metadata subset needs nothing else)."""

    def __init__(self):
        self._out = bytearray()

    def varint(self, field: int, v: int) -> "_Msg":
        self._out += _uvarint(field << 3 | 0) + _uvarint(int(v))
        return self

    def bytes_(self, field: int, b: bytes) -> "_Msg":
        self._out += _uvarint(field << 3 | 2) + _uvarint(len(b)) + b
        return self

    def msg(self, field: int, m: "_Msg") -> "_Msg":
        return self.bytes_(field, bytes(m._out))

    def string(self, field: int, s: str) -> "_Msg":
        return self.bytes_(field, s.encode())

    def encode(self) -> bytes:
        return bytes(self._out)


def _pb_decode(data: bytes) -> Dict[int, List[Any]]:
    """Generic decode: field -> list of values (int for varint, bytes for
    length-delimited); repeated fields accumulate in order."""
    out: Dict[int, List[Any]] = {}
    pos = 0
    while pos < len(data):
        tag, pos = _read_uvarint(data, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            v, pos = _read_uvarint(data, pos)
        elif wt == 2:
            ln, pos = _read_uvarint(data, pos)
            v = data[pos:pos + ln]
            pos += ln
        elif wt == 5:
            v = struct.unpack("<I", data[pos:pos + 4])[0]
            pos += 4
        elif wt == 1:
            v = struct.unpack("<Q", data[pos:pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        out.setdefault(field, []).append(v)
    return out


def _one(msg: Dict[int, List[Any]], field: int, default=None):
    return msg[field][0] if field in msg else default


# ---------------------------------------------------------------------------
# compression (chunked: 3-byte little-endian header = length*2 + isOriginal)
# ---------------------------------------------------------------------------

_CHUNK = 256 * 1024


def _compress_stream(data: bytes, kind: int) -> bytes:
    if kind == COMP_NONE or not data:
        return data
    out = bytearray()
    for lo in range(0, len(data), _CHUNK):
        chunk = data[lo:lo + _CHUNK]
        comp = zlib.compressobj(wbits=-15)
        z = comp.compress(chunk) + comp.flush()
        if len(z) < len(chunk):
            hdr = len(z) * 2
            body = z
        else:
            hdr = len(chunk) * 2 + 1
            body = chunk
        out += struct.pack("<I", hdr)[:3] + body
    return bytes(out)


def _decompress_stream(data: bytes, kind: int) -> bytes:
    if kind == COMP_NONE:
        return data
    out = bytearray()
    pos = 0
    while pos < len(data):
        hdr = struct.unpack("<I", data[pos:pos + 3] + b"\0")[0]
        pos += 3
        ln, original = hdr >> 1, hdr & 1
        chunk = data[pos:pos + ln]
        pos += ln
        out += chunk if original else zlib.decompress(chunk, wbits=-15)
    return bytes(out)


# ---------------------------------------------------------------------------
# byte RLE + boolean bit RLE
# ---------------------------------------------------------------------------

def _byte_rle_encode(vals: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(vals)
    while i < n:
        run = 1
        while i + run < n and run < 130 and vals[i + run] == vals[i]:
            run += 1
        if run >= 3:
            out.append(run - 3)
            out.append(vals[i])
            i += run
            continue
        lit = i
        while i < n and i - lit < 128:
            nxt = 1
            while i + nxt < n and nxt < 3 and vals[i + nxt] == vals[i]:
                nxt += 1
            if nxt >= 3 and i > lit:
                break
            if nxt >= 3:
                break
            i += 1
        if i == lit:                 # run >= 3 starts right here
            continue
        out.append(256 - (i - lit))  # -count as unsigned byte
        out += vals[lit:i]
    return bytes(out)


def _byte_rle_decode(data: bytes, n: int) -> bytes:
    out = bytearray()
    pos = 0
    while len(out) < n:
        ctrl = data[pos]
        pos += 1
        if ctrl < 128:               # run of ctrl+3 copies
            out += bytes([data[pos]]) * (ctrl + 3)
            pos += 1
        else:                        # 256-ctrl literals
            k = 256 - ctrl
            out += data[pos:pos + k]
            pos += k
    return bytes(out[:n])


def _bool_encode(mask: np.ndarray) -> bytes:
    bits = np.packbits(mask.astype(bool))  # MSB-first, the ORC bit order
    return _byte_rle_encode(bits.tobytes())


def _bool_decode(data: bytes, n: int) -> np.ndarray:
    nbytes = (n + 7) // 8
    raw = np.frombuffer(_byte_rle_decode(data, nbytes), np.uint8)
    return np.unpackbits(raw)[:n].astype(bool)


# ---------------------------------------------------------------------------
# integer RLE version 1 (the writer's encoding; DIRECT)
# ---------------------------------------------------------------------------

def _rle1_encode(vals: np.ndarray, signed: bool) -> bytes:
    enc = (_svarint if signed else _uvarint)
    out = bytearray()
    v = vals.tolist()
    i, n = 0, len(v)
    while i < n:
        # run: >=3 values with a constant delta in [-128, 127]
        run = 1
        if i + 1 < n:
            delta = v[i + 1] - v[i]
            if -128 <= delta <= 127:
                run = 2
                while i + run < n and run < 130 \
                        and v[i + run] - v[i + run - 1] == delta:
                    run += 1
        if run >= 3:
            out.append(run - 3)
            out += struct.pack("b", delta)
            out += enc(v[i])
            i += run
            continue
        lit = i
        while i < n and i - lit < 128:
            if i + 2 < n and v[i + 1] - v[i] == v[i + 2] - v[i + 1] \
                    and -128 <= v[i + 1] - v[i] <= 127:
                break                # a run starts here
            i += 1
        if i == lit:
            i += 1                   # lone head of a run boundary
        out.append(256 - (i - lit))
        for x in v[lit:i]:
            out += enc(x)
    return bytes(out)


def _rle1_decode(data: bytes, n: int, signed: bool) -> np.ndarray:
    out = np.empty(n, np.int64)
    m = pos = 0
    while m < n:
        ctrl = data[pos]
        pos += 1
        if ctrl < 128:
            count = ctrl + 3
            delta = struct.unpack("b", data[pos:pos + 1])[0]
            pos += 1
            base, pos = _read_uvarint(data, pos)
            if signed:
                base = _unzig(base)
            out[m:m + count] = base + delta * np.arange(count)
            m += count
        else:
            for _ in range(256 - ctrl):
                x, pos = _read_uvarint(data, pos)
                v = _unzig(x) if signed else x
                if v >= 1 << 63:
                    v -= 1 << 64    # 64-bit two's-complement wrap (the
                    #                 signed nanos in the unsigned stream)
                out[m] = v
                m += 1
    return out


# ---------------------------------------------------------------------------
# integer RLE version 2 (reader; DIRECT_V2 of modern writers)
# ---------------------------------------------------------------------------

def _unpack_bits(data: bytes, pos: int, count: int, width: int
                 ) -> Tuple[np.ndarray, int]:
    """``count`` big-endian ``width``-bit unsigned ints from ``data``:
    vectorized via a [count, width] bit matrix dotted with powers of 2."""
    nbytes = (count * width + 7) // 8
    bits = np.unpackbits(np.frombuffer(data[pos:pos + nbytes], np.uint8),
                         count=count * width).reshape(count, width)
    powers = (np.uint64(1) << np.arange(width - 1, -1, -1,
                                        dtype=np.uint64))
    out = (bits.astype(np.uint64) * powers).sum(axis=1)
    return out.astype(np.int64, copy=False), pos + nbytes


def _rle2_decode(data: bytes, n: int, signed: bool) -> np.ndarray:
    out = np.empty(n, np.int64)
    m = pos = 0
    while m < n:
        hdr = data[pos]
        kind = hdr >> 6
        if kind == 0:                      # SHORT_REPEAT
            width = ((hdr >> 3) & 7) + 1
            count = (hdr & 7) + 3
            val = int.from_bytes(data[pos + 1:pos + 1 + width], "big")
            pos += 1 + width
            if signed:
                val = _unzig(val)
            out[m:m + count] = val
            m += count
        elif kind == 1:                    # DIRECT
            width = _V2_WIDTHS[(hdr >> 1) & 0x1F]
            count = ((hdr & 1) << 8 | data[pos + 1]) + 1
            pos += 2
            vals, pos = _unpack_bits(data, pos, count, width)
            if signed:
                vals = (vals >> 1) ^ -(vals & 1)
            out[m:m + count] = vals
            m += count
        elif kind == 3:                    # DELTA
            wcode = (hdr >> 1) & 0x1F
            width = 0 if wcode == 0 else _V2_WIDTHS[wcode]
            count = ((hdr & 1) << 8 | data[pos + 1]) + 1
            pos += 2
            base, pos = _read_uvarint(data, pos)
            if signed:
                base = _unzig(base)
            db, pos = _read_uvarint(data, pos)
            delta_base = _unzig(db)        # delta base is ALWAYS signed
            seq = [base]
            if count > 1:
                seq.append(base + delta_base)
            if count > 2:
                if width == 0:
                    for _ in range(count - 2):
                        seq.append(seq[-1] + delta_base)
                else:
                    deltas, pos = _unpack_bits(data, pos, count - 2, width)
                    sign = 1 if delta_base >= 0 else -1
                    for d in deltas.tolist():
                        seq.append(seq[-1] + sign * d)
            out[m:m + count] = seq
            m += count
        else:                              # PATCHED_BASE
            width = _V2_WIDTHS[(hdr >> 1) & 0x1F]
            count = ((hdr & 1) << 8 | data[pos + 1]) + 1
            b3, b4 = data[pos + 2], data[pos + 3]
            bw = ((b3 >> 5) & 7) + 1       # base width, bytes
            pw = _V2_WIDTHS[b3 & 0x1F]     # patch width, bits
            pgw = ((b4 >> 5) & 7) + 1      # patch gap width, bits
            pll = b4 & 0x1F                # patch list length
            pos += 4
            base = int.from_bytes(data[pos:pos + bw], "big")
            msb = 1 << (bw * 8 - 1)
            if base & msb:                 # sign-magnitude base
                base = -(base & (msb - 1))
            pos += bw
            vals, pos = _unpack_bits(data, pos, count, width)
            if pll:
                entries, pos = _unpack_bits(data, pos, pll, pgw + pw)
                idx = 0
                for e in entries.tolist():
                    gap, patch = e >> pw, e & ((1 << pw) - 1)
                    idx += gap
                    if patch:
                        vals[idx] |= patch << width
            out[m:m + count] = base + vals
            m += count
    return out


def _int_decode(data: bytes, n: int, signed: bool, encoding: int
                ) -> np.ndarray:
    if encoding in (ENC_DIRECT_V2, ENC_DICTIONARY_V2):
        return _rle2_decode(data, n, signed)
    return _rle1_decode(data, n, signed)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _orc_kind(arr: np.ndarray) -> int:
    dt = arr.dtype
    if dt == np.bool_:
        return K_BOOLEAN
    if np.issubdtype(dt, np.datetime64):
        return K_TIMESTAMP
    if dt == np.int32:
        return K_INT
    if np.issubdtype(dt, np.integer):
        return K_LONG
    if dt == np.float32:
        return K_FLOAT
    if np.issubdtype(dt, np.floating):
        return K_DOUBLE
    if dt == object and len(arr):
        import decimal
        head = next((v for v in arr.tolist() if v is not None), None)
        if isinstance(head, decimal.Decimal):
            return K_DECIMAL
    return K_STRING


def _nanos_encode(nanos: np.ndarray) -> np.ndarray:
    """ORC scaled nanoseconds: trailing decimal zeros strip off, their
    count (minus one) rides the low 3 bits — 1000 serializes as
    ``(1 << 3) | 2``.  Values may be NEGATIVE (pre-1970 sub-second
    remainders under the truncate-toward-zero seconds convention): the
    shifted mantissa keeps its sign and the low bits ride two's
    complement, matching the C++ ORC writer (-0.5s → enc -33)."""
    out = np.empty(len(nanos), np.int64)
    for i, n in enumerate(nanos.tolist()):
        a = -n if n < 0 else n
        z = 0
        if a:
            while a % 10 == 0 and z < 8:
                a //= 10
                z += 1
        if z >= 2:
            m = -a if n < 0 else a
            out[i] = (m << 3) | (z - 1)
        else:
            # 0 or 1 trailing zeros cannot be stripped (the 3-bit field
            # encodes 2..8 removed zeros); store the raw value
            out[i] = int(n) << 3
    return out


def _nanos_decode(enc: np.ndarray) -> np.ndarray:
    zeros = enc & 7
    vals = enc >> 3
    scale = np.where(zeros > 0, 10 ** (zeros + 1), 1)
    return vals * scale


def _decimal_streams(arr: np.ndarray) -> List[Tuple[int, bytes]]:
    """DECIMAL: unbounded zigzag-varint mantissas + a signed RLE scale
    stream (per-value scales are legal; readers rescale to the declared
    type scale)."""
    data = bytearray()
    scales = np.empty(len(arr), np.int64)
    for i, v in enumerate(arr.tolist()):
        t = v.as_tuple()
        scale = max(-t.exponent, 0)
        mantissa = int(v.scaleb(scale))
        scales[i] = scale
        # zigzag over arbitrary-precision ints: -1 flips all bits
        n = ((mantissa << 1) ^ -1) if mantissa < 0 else mantissa << 1
        while True:
            b = n & 0x7F
            n >>= 7
            if n:
                data.append(b | 0x80)
            else:
                data.append(b)
                break
    return [(STREAM_DATA, bytes(data)),
            (STREAM_SECONDARY, _rle1_encode(scales, signed=True))]


def _column_streams(arr: np.ndarray, kind: int) -> List[Tuple[int, bytes]]:
    """(stream kind, raw bytes) for one non-null column."""
    if kind == K_BOOLEAN:
        return [(STREAM_DATA, _bool_encode(np.asarray(arr, bool)))]
    if kind in (K_INT, K_LONG, K_SHORT, K_BYTE):
        return [(STREAM_DATA,
                 _rle1_encode(np.asarray(arr, np.int64), signed=True))]
    if kind == K_FLOAT:
        return [(STREAM_DATA,
                 np.asarray(arr, "<f4").tobytes())]
    if kind == K_DOUBLE:
        return [(STREAM_DATA, np.asarray(arr, "<f8").tobytes())]
    if kind == K_TIMESTAMP:
        ns = np.asarray(arr, "datetime64[ns]").astype(np.int64)
        # seconds TRUNCATE toward zero and the nanos remainder carries the
        # sign (the C++ ORC convention: floor-encoded pre-1970 fractional
        # values read back one second early in foreign readers)
        secs = ns // 1_000_000_000
        rem = ns - secs * 1_000_000_000
        adjust = (ns < 0) & (rem != 0)
        secs = secs + adjust
        nanos = rem - adjust * 1_000_000_000
        enc = _nanos_encode(nanos)
        # negative encodings ride the unsigned stream as 64-bit two's
        # complement (what the C++ writer emits)
        enc_u = [int(x) & 0xFFFFFFFFFFFFFFFF for x in enc.tolist()]
        return [(STREAM_DATA,
                 _rle1_encode(secs - _ORC_EPOCH_S, signed=True)),
                (STREAM_SECONDARY,
                 _rle1_encode(np.asarray(enc_u, object), signed=False))]
    if kind == K_DECIMAL:
        return _decimal_streams(arr)
    if kind == K_STRING:
        blobs = [("" if v is None else str(v)).encode() for v in
                 arr.tolist()]
        lengths = np.asarray([len(b) for b in blobs], np.int64)
        return [(STREAM_DATA, b"".join(blobs)),
                (STREAM_LENGTH, _rle1_encode(lengths, signed=False))]
    raise ValueError(f"unsupported ORC kind {kind}")


def write_orc(batches: Iterable[RecordBatch], path: str,
              compression: str = "zlib",
              stripe_rows: int = 1 << 16) -> int:
    """Drain ``batches`` into an ORC file (one stripe per ``stripe_rows``
    rows).  Returns rows written."""
    comp = {"none": COMP_NONE, "zlib": COMP_ZLIB}[compression]
    pending: List[RecordBatch] = []
    pending_rows = 0
    names: Optional[List[str]] = None
    kinds: Optional[List[int]] = None
    stripes: List[Dict[str, int]] = []
    total_rows = 0

    with open(path, "wb") as f:
        f.write(MAGIC)

        def flush_stripe():
            nonlocal pending, pending_rows, total_rows
            if not pending_rows:
                return
            merged = (pending[0] if len(pending) == 1
                      else RecordBatch.concat(pending))
            pending, pending_rows = [], 0
            offset = f.tell()
            sf_streams = _Msg()
            data_parts: List[bytes] = []
            # struct root (column 0) has no streams; encodings cover it
            encodings = [_Msg().varint(1, ENC_DIRECT)]
            for col, (name, kind) in enumerate(zip(names, kinds), start=1):
                arr = np.asarray(merged.column(name))
                for skind, raw in _column_streams(arr, kind):
                    blob = _compress_stream(raw, comp)
                    sf_streams.msg(1, _Msg().varint(1, skind)
                                   .varint(2, col).varint(3, len(blob)))
                    data_parts.append(blob)
                encodings.append(_Msg().varint(1, ENC_DIRECT))
            data = b"".join(data_parts)
            f.write(data)
            for e in encodings:
                sf_streams.msg(2, e)
            sfoot = _compress_stream(sf_streams.encode(), comp)
            f.write(sfoot)
            stripes.append({"offset": offset, "index": 0,
                            "data": len(data), "footer": len(sfoot),
                            "rows": len(merged)})
            total_rows += len(merged)

        for b in batches:
            if len(b) == 0:
                if names is None:
                    names = list(b.columns)
                    kinds = [_orc_kind(np.asarray(b.column(c)))
                             for c in names]
                continue
            if names is None:
                names = list(b.columns)
                kinds = [_orc_kind(np.asarray(b.column(c))) for c in names]
            pending.append(b)
            pending_rows += len(b)
            if pending_rows >= stripe_rows:
                flush_stripe()
        flush_stripe()
        if names is None:
            names, kinds = [], []

        body_end = f.tell()
        footer = _Msg()
        footer.varint(1, len(MAGIC))                 # headerLength
        footer.varint(2, body_end)                   # contentLength
        for s in stripes:
            footer.msg(3, _Msg().varint(1, s["offset"])
                       .varint(2, s["index"]).varint(3, s["data"])
                       .varint(4, s["footer"]).varint(5, s["rows"]))
        root = _Msg().varint(1, K_STRUCT)
        for i, name in enumerate(names, start=1):
            root.varint(2, i)
        for name in names:
            root.string(3, name)
        footer.msg(4, root)
        for kind in kinds:
            tm = _Msg().varint(1, kind)
            if kind == K_DECIMAL:
                tm.varint(5, 38).varint(6, 18)   # precision/scale attrs
            footer.msg(4, tm)
        footer.varint(6, total_rows)
        footer.varint(8, 0)                          # rowIndexStride: none
        fblob = _compress_stream(footer.encode(), comp)
        f.write(fblob)

        ps = _Msg()
        ps.varint(1, len(fblob))                     # footerLength
        ps.varint(2, comp)
        ps.varint(3, _CHUNK)
        ps.varint(4, 0).varint(4, 12)                # version 0.12
        ps.varint(5, 0)                              # metadataLength
        ps.varint(6, 1)                              # writerVersion
        ps.string(8000, "ORC")
        psb = ps.encode()
        f.write(psb)
        f.write(bytes([len(psb)]))
    return total_rows


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

_KIND_SIGNED = {K_BYTE, K_SHORT, K_INT, K_LONG}


def read_orc(path: str, batch_size: int = 0,
             timestamp_column: Optional[str] = None
             ) -> Iterator[RecordBatch]:
    """One RecordBatch per stripe (``batch_size`` ignored: the stripe is
    the natural vectorized unit, as in the reference's columnar reader)."""
    with open(path, "rb") as f:
        raw = f.read()
    if not raw.startswith(MAGIC):
        raise ValueError("not an ORC file (bad magic)")
    ps_len = raw[-1]
    ps = _pb_decode(raw[-1 - ps_len:-1])
    comp = _one(ps, 2, COMP_NONE)
    flen = _one(ps, 1)
    footer = _pb_decode(_decompress_stream(
        raw[-1 - ps_len - flen:-1 - ps_len], comp))
    types = [_pb_decode(t) for t in footer.get(4, [])]
    if not types or _one(types[0], 1, K_STRUCT) != K_STRUCT:
        raise ValueError("unsupported ORC schema: root must be a struct")
    names = [n.decode() for n in types[0].get(3, [])]
    kinds = [_one(types[i], 1) for i in range(1, len(types))]
    for s in footer.get(3, []):
        si = _pb_decode(s)
        offset = _one(si, 1, 0)
        ilen = _one(si, 2, 0)
        dlen = _one(si, 3, 0)
        sflen = _one(si, 4, 0)
        rows = _one(si, 5, 0)
        sfoot = _pb_decode(_decompress_stream(
            raw[offset + ilen + dlen:offset + ilen + dlen + sflen], comp))
        enc_msgs = [_pb_decode(e) for e in sfoot.get(2, [])]
        encodings = [_one(e, 1, ENC_DIRECT) for e in enc_msgs]
        dict_sizes = [_one(e, 2, 0) for e in enc_msgs]
        # stream directory: walk in order, tracking byte offsets
        streams: Dict[Tuple[int, int], bytes] = {}
        cursor = offset
        for st in sfoot.get(1, []):
            sm = _pb_decode(st)
            skind = _one(sm, 1, STREAM_DATA)
            col = _one(sm, 2, 0)
            ln = _one(sm, 3, 0)
            streams[(col, skind)] = raw[cursor:cursor + ln]
            cursor += ln
        cols: Dict[str, np.ndarray] = {}
        for j, (name, kind) in enumerate(zip(names, kinds)):
            col = j + 1
            enc = encodings[col] if col < len(encodings) else ENC_DIRECT

            def stream(skind, _col=col):
                blob = streams.get((_col, skind))
                return (None if blob is None
                        else _decompress_stream(blob, comp))

            present = stream(STREAM_PRESENT)
            n_phys = rows
            mask = None
            if present is not None:
                mask = _bool_decode(present, rows)
                n_phys = int(mask.sum())
            data = stream(STREAM_DATA)
            if kind == K_BOOLEAN:
                vals: Any = _bool_decode(data, n_phys)
            elif kind in _KIND_SIGNED:
                vals = _int_decode(data, n_phys, True, enc)
                if kind == K_INT:
                    vals = vals.astype(np.int32)
            elif kind == K_FLOAT:
                vals = np.frombuffer(data, "<f4", count=n_phys).copy()
            elif kind == K_DOUBLE:
                vals = np.frombuffer(data, "<f8", count=n_phys).copy()
            elif kind == K_TIMESTAMP:
                secs = _int_decode(data, n_phys, True, enc)
                nanos = _nanos_decode(_int_decode(
                    stream(STREAM_SECONDARY), n_phys, False, enc))
                ns = (secs + _ORC_EPOCH_S) * 1_000_000_000 + nanos
                vals = ns.astype("datetime64[ns]")
            elif kind == K_DECIMAL:
                import decimal
                scale_attr = _one(types[col], 6, 0)
                scales = None
                sec = stream(STREAM_SECONDARY)
                if sec:
                    scales = _int_decode(sec, n_phys, True, enc)
                mants: List[int] = []
                pos = 0
                for _ in range(n_phys):
                    u, pos = _read_uvarint(data, pos)
                    mants.append(_unzig(u))
                vals = np.asarray(
                    [decimal.Decimal(m).scaleb(
                        -int(scales[i] if scales is not None
                             else scale_attr))
                     for i, m in enumerate(mants)], object)
            elif kind in (K_STRING, K_BINARY):
                is_dict = enc in (ENC_DICTIONARY, ENC_DICTIONARY_V2)
                lens = _int_decode(
                    stream(STREAM_LENGTH),
                    dict_sizes[col] if is_dict else n_phys, False, enc)
                if is_dict:
                    dict_blob = stream(STREAM_DICT_DATA) or b""
                    ends = np.cumsum(lens)
                    starts = ends - lens
                    entries = [dict_blob[s:e].decode()
                               for s, e in zip(starts.tolist(),
                                               ends.tolist())]
                    idx = _int_decode(data, n_phys, False, enc)
                    vals = np.asarray([entries[i] for i in idx.tolist()],
                                      object)
                else:
                    ends = np.cumsum(lens)
                    starts = ends - lens
                    vals = np.asarray([data[s:e].decode()
                                       for s, e in zip(starts.tolist(),
                                                       ends.tolist())],
                                      object)
            else:
                raise ValueError(f"unsupported ORC type kind {kind}")
            if mask is not None and n_phys != rows:
                full = np.empty(rows, object)
                full[:] = None
                full[np.flatnonzero(mask)] = (
                    vals.tolist() if isinstance(vals, np.ndarray) else vals)
                vals = full
            cols[name] = np.asarray(vals)
        ts = (np.asarray(cols[timestamp_column], np.int64)
              if timestamp_column else None)
        yield RecordBatch(cols, timestamps=ts)

"""Columnar RecordBatch wire codec ("FTB1").

The record serialization layer of the data plane — the analog of the
reference's ``SpanningRecordSerializer`` + Cython fast coders
(``RecordWriter.serializeRecord``, ``pyflink/fn_execution/coder_impl_fast.pyx``)
redesigned columnar: a batch serializes as a handful of compressed column
blocks instead of per-record length-prefixed tuples, so the cost is O(columns)
calls + memcpy-speed block compression, not O(records) dispatch.

Block format: ``method u8 | varint orig_len | varint payload_len | payload``
with method 0 = raw, 1 = FLZ (native), 2 = zlib (fallback), 3 = delta-varint
(int64 only).  Timestamps use delta-varint (they arrive nearly sorted).

The port's copy of ``flink_tpu/native/codec.py``: the same format and the
same bytes, through the port's codec library (``csrc/codec.cc``).  The
encoder always writes FLZ blocks (the port has no zlib fallback: a codec
library that does not build raises); the decoder still reads method 2, the
blocks JAX's encoder writes where its native library is missing.
"""

from __future__ import annotations

import pickle
import zlib
from typing import Tuple

import numpy as np

from flink_tpu_torch.core.batch import RecordBatch
from flink_tpu_torch.native import (delta_varint_decode, delta_varint_encode,
                                    lz_compress, lz_decompress)

MAGIC = b"FTB1"
_RAW, _FLZ, _ZLIB, _DVAR = 0, 1, 2, 3
_MIN_COMPRESS = 64  # don't bother compressing tiny blocks


def _put_varint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _get_varint(data: bytes, pos: int) -> Tuple[int, int]:
    v = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


def _put_block(out: bytearray, raw: bytes, compress: bool = True) -> None:
    method, payload = _RAW, raw
    if compress and len(raw) >= _MIN_COMPRESS:
        c = lz_compress(raw)
        if len(c) < len(raw):
            method, payload = _FLZ, c
    out.append(method)
    _put_varint(out, len(raw))
    _put_varint(out, len(payload))
    out += payload


def _put_i64_block(out: bytearray, vals: np.ndarray, compress: bool = True) -> None:
    enc = delta_varint_encode(vals)
    if len(enc) < vals.nbytes:
        # nested block: the delta-varint stream itself is often repetitive
        # (constant inter-arrival gaps) so it gets a second LZ pass
        out.append(_DVAR)
        _put_varint(out, vals.size)
        _put_block(out, enc, compress)
    else:
        _put_block(out, np.ascontiguousarray(vals, np.int64).tobytes(), compress)


def _get_block(data: bytes, pos: int) -> Tuple[bytes, int]:
    method = data[pos]
    pos += 1
    if method == _DVAR:
        n, pos = _get_varint(data, pos)
        enc, pos = _get_block(data, pos)
        return delta_varint_decode(enc, n).tobytes(), pos
    orig, pos = _get_varint(data, pos)
    plen, pos = _get_varint(data, pos)
    payload = data[pos:pos + plen]
    pos += plen
    if method == _RAW:
        return payload, pos
    if method == _FLZ:
        return lz_decompress(payload, orig), pos
    if method == _ZLIB:
        return zlib.decompress(payload), pos
    raise ValueError(f"unknown block method {method}")


def encode_batch(batch: RecordBatch, compress: bool = True) -> bytes:
    out = bytearray(MAGIC)
    flags = ((batch.timestamps is not None) |
             ((batch.key_ids is not None) << 1) |
             ((batch.key_groups is not None) << 2))
    out.append(flags)
    _put_varint(out, len(batch))
    _put_varint(out, len(batch.columns))
    if batch.timestamps is not None:
        _put_i64_block(out, np.asarray(batch.timestamps, np.int64), compress)
    if batch.key_ids is not None:
        _put_block(out, np.ascontiguousarray(batch.key_ids, np.int32).tobytes(), compress)
    if batch.key_groups is not None:
        _put_block(out, np.ascontiguousarray(batch.key_groups, np.int32).tobytes(), compress)
    for name, col in batch.columns.items():
        nb = name.encode()
        _put_varint(out, len(nb))
        out += nb
        a = np.asarray(col)
        if a.dtype == object:
            out.append(1)
            _put_block(out, pickle.dumps(list(a), protocol=4), compress)
        else:
            out.append(0)
            ds = a.dtype.str.encode()
            _put_varint(out, len(ds))
            out += ds
            _put_varint(out, a.ndim)
            for d in a.shape:
                _put_varint(out, d)
            if a.dtype == np.int64 and a.ndim == 1:
                _put_i64_block(out, a, compress)
            else:
                _put_block(out, np.ascontiguousarray(a).tobytes(), compress)
    return bytes(out)


def decode_batch(data: bytes) -> RecordBatch:
    if data[:4] != MAGIC:
        raise ValueError("bad batch magic")
    pos = 4
    flags = data[pos]
    pos += 1
    n, pos = _get_varint(data, pos)
    n_cols, pos = _get_varint(data, pos)
    ts = kid = kg = None
    if flags & 1:
        raw, pos = _get_block(data, pos)
        ts = np.frombuffer(raw, np.int64).copy()
    if flags & 2:
        raw, pos = _get_block(data, pos)
        kid = np.frombuffer(raw, np.int32).copy()
    if flags & 4:
        raw, pos = _get_block(data, pos)
        kg = np.frombuffer(raw, np.int32).copy()
    cols = {}
    for _ in range(n_cols):
        ln, pos = _get_varint(data, pos)
        name = data[pos:pos + ln].decode()
        pos += ln
        kind = data[pos]
        pos += 1
        if kind == 1:
            raw, pos = _get_block(data, pos)
            cols[name] = np.asarray(pickle.loads(raw), dtype=object)
        else:
            ln, pos = _get_varint(data, pos)
            dtype = np.dtype(data[pos:pos + ln].decode())
            pos += ln
            ndim, pos = _get_varint(data, pos)
            shape = []
            for _ in range(ndim):
                d, pos = _get_varint(data, pos)
                shape.append(d)
            raw, pos = _get_block(data, pos)
            cols[name] = np.frombuffer(raw, dtype).reshape(shape).copy()
    return RecordBatch(cols, ts, kid, kg)

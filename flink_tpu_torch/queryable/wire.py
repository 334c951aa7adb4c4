"""Binary columnar wire protocol: production-QPS frames for the serving tier
(port of ``flink_tpu/queryable/wire.py``; the bytes are the JAX codec's, so a
client of one package talks to a server of the other).

The length-prefixed JSON protocol spends its whole budget on Python objects — one dict per key, one ``json.dumps`` per
response — which capped the tier at ~7.6k lookups/s.  This codec serializes
**dtype-tagged ndarray columns straight off the immutable view/replica
segments**: a 256-key answer is one ``found`` byte plane plus a handful of
raw column buffers (``np.frombuffer`` on the client), with zero per-key
Python objects on either side.

Framing (all little-endian, inside the transport's usual ``u32`` length
prefix; ``MAGIC`` = 0xFB cannot begin a JSON document, so one peek
negotiates the protocol — JSON requests keep getting JSON answers and old
clients never notice the server got faster):

Request  (kind ``REQ_LOOKUP``)::

    MAGIC u8 | version u8 | kind u8 | consistency u8 | keytag u8 |
    state_len u16 | state utf-8 | nkeys u32 | key payload

    keytag 0: raw int64 keys (nkeys * 8 bytes — the dense-key fast path)
    keytag 1: JSON array utf-8 (payload_len u32 | bytes) — object keys

Response::

    MAGIC u8 | version u8 | status u8
    status OK   : nkeys u32 | found uint8[nkeys] | ncols u16 |
                  ncols x [name_len u16 | name | dtag_len u8 | dtag |
                           nbytes u32 | raw column bytes] |
                  tags_len u32 | tags JSON
    status ERR  : msg_len u32 | msg utf-8

Column rules: every column covers all ``nkeys`` query positions (rows whose
``found`` bit is 0 are zero/None filler — the client masks them), numeric
columns ship their C-contiguous bytes with the numpy dtype string as the
tag, and object-dtype columns (string results) fall back to a JSON-encoded
list under the reserved tag ``obj``.  Unknown versions fail loudly; new
columns are forward-compatible by construction (clients index by name).

``values_from_columnar`` reconstructs the JSON protocol's per-key dict answers from a
columnar payload through the same :func:`~flink_tpu_torch.queryable.view.plain`
coercion the JSON path uses — the mechanism behind the bench's
binary==JSON answer-equality gate.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

MAGIC = 0xFB
WIRE_VERSION = 1

REQ_LOOKUP = 1

_OK, _ERR = 0, 1
_KEY_I64, _KEY_JSON = 0, 1

_REQ_HEAD = struct.Struct("<BBBBBH")     # magic ver kind consistency keytag
_U32 = struct.Struct("<I")               # state_len
_U16 = struct.Struct("<H")
_COL_HEAD = struct.Struct("<H")          # name_len

#: consistency levels on the wire
_CONS = ("live", "checkpoint")

#: object-dtype columns ride as JSON (reserved dtype tag)
OBJ_TAG = b"obj"


def is_binary(payload: bytes) -> bool:
    """Protocol negotiation: one byte peek.  0xFB can never start a JSON
    document, so a JSON request (old client) falls through untouched."""
    return bool(payload) and payload[0] == MAGIC


class WireError(ValueError):
    """Malformed or version-incompatible binary frame."""


def encode_request(state: str, keys, consistency: str = "live") -> bytes:
    """Batched lookup request.  Integer key arrays take the raw-int64 fast
    path (no per-key Python objects); anything else ships as JSON."""
    try:
        cons = _CONS.index(consistency)
    except ValueError:
        raise WireError(f"unknown consistency {consistency!r}")
    sb = state.encode()
    karr = keys if isinstance(keys, np.ndarray) else None
    if karr is None and isinstance(keys, (list, tuple)) \
            and keys and all(isinstance(k, (int, np.integer))
                             and not isinstance(k, bool) for k in keys):
        karr = np.asarray(keys, np.int64)
    if karr is not None and karr.dtype.kind in "iu":
        karr = np.ascontiguousarray(karr, np.int64)
        head = _REQ_HEAD.pack(MAGIC, WIRE_VERSION, REQ_LOOKUP, cons,
                              _KEY_I64, len(sb))
        return head + sb + _U32.pack(len(karr)) + karr.tobytes()
    kjson = json.dumps(list(keys)).encode()
    head = _REQ_HEAD.pack(MAGIC, WIRE_VERSION, REQ_LOOKUP, cons,
                          _KEY_JSON, len(sb))
    return head + sb + _U32.pack(len(list(keys))) \
        + _U32.pack(len(kjson)) + kjson


def decode_request(payload: bytes) -> Tuple[str, Any, str]:
    """-> (state, keys — int64 ndarray or list, consistency)."""
    if len(payload) < _REQ_HEAD.size:
        raise WireError("short frame")
    magic, ver, kind, cons, keytag, slen = _REQ_HEAD.unpack_from(payload, 0)
    if magic != MAGIC:
        raise WireError("not a binary frame")
    if ver != WIRE_VERSION:
        raise WireError(f"unsupported wire version {ver} "
                        f"(this server speaks {WIRE_VERSION})")
    if kind != REQ_LOOKUP:
        raise WireError(f"unknown request kind {kind}")
    if not 0 <= cons < len(_CONS):
        raise WireError(f"unknown consistency code {cons}")
    off = _REQ_HEAD.size
    state = payload[off:off + slen].decode()
    off += slen
    (nkeys,) = _U32.unpack_from(payload, off)
    off += _U32.size
    if keytag == _KEY_I64:
        end = off + 8 * nkeys
        if end > len(payload):
            raise WireError("truncated key payload")
        keys = np.frombuffer(payload, np.dtype("<i8"), nkeys, off)
        return state, keys, _CONS[cons]
    if keytag == _KEY_JSON:
        (jlen,) = _U32.unpack_from(payload, off)
        off += _U32.size
        keys = json.loads(payload[off:off + jlen])
        if not isinstance(keys, list) or len(keys) != nkeys:
            raise WireError("key payload does not match declared count")
        return state, keys, _CONS[cons]
    raise WireError(f"unknown key tag {keytag}")


def encode_response(found: np.ndarray, cols: Dict[str, np.ndarray],
                    tags: Dict[str, Any]) -> bytes:
    """OK answer: the columnar payload, zero per-key objects.  ``cols``
    arrays must be 1-D and cover every query position."""
    n = len(found)
    parts = [bytes((MAGIC, WIRE_VERSION, _OK)), _U32.pack(n),
             np.ascontiguousarray(found, np.uint8).tobytes(),
             _U16.pack(len(cols))]
    for name, arr in cols.items():
        nb = name.encode()
        parts.append(_COL_HEAD.pack(len(nb)))
        parts.append(nb)
        arr = np.asarray(arr)
        if arr.dtype.kind == "O":
            raw = json.dumps([None if v is None else _py(v)
                              for v in arr.tolist()]).encode()
            tag = OBJ_TAG
        else:
            arr = np.ascontiguousarray(arr)
            raw = arr.tobytes()
            tag = arr.dtype.str.encode()
        parts.append(bytes((len(tag),)))
        parts.append(tag)
        parts.append(_U32.pack(len(raw)))
        parts.append(raw)
    tj = json.dumps(tags, default=_py).encode()
    parts.append(_U32.pack(len(tj)))
    parts.append(tj)
    return b"".join(parts)


def encode_error(msg: str) -> bytes:
    mb = str(msg).encode()
    return bytes((MAGIC, WIRE_VERSION, _ERR)) + _U32.pack(len(mb)) + mb


def decode_response(payload: bytes) -> Tuple[np.ndarray,
                                             Dict[str, np.ndarray],
                                             Dict[str, Any]]:
    """-> (found bool[n], {col: ndarray[n]}, tags).  Raises
    :class:`WireError` on malformed frames, ``RuntimeError`` on a server
    error reply (mirrors the JSON client's error contract)."""
    if len(payload) < 3 or payload[0] != MAGIC:
        raise WireError("not a binary frame")
    if payload[1] != WIRE_VERSION:
        raise WireError(f"unsupported wire version {payload[1]}")
    status = payload[2]
    off = 3
    if status == _ERR:
        (mlen,) = _U32.unpack_from(payload, off)
        off += _U32.size
        raise RuntimeError(payload[off:off + mlen].decode())
    if status != _OK:
        raise WireError(f"unknown response status {status}")
    (n,) = _U32.unpack_from(payload, off)
    off += _U32.size
    found = np.frombuffer(payload, np.uint8, n, off).astype(bool)
    off += n
    (ncols,) = _U16.unpack_from(payload, off)
    off += _U16.size
    cols: Dict[str, np.ndarray] = {}
    for _ in range(ncols):
        (nlen,) = _COL_HEAD.unpack_from(payload, off)
        off += _COL_HEAD.size
        name = payload[off:off + nlen].decode()
        off += nlen
        tlen = payload[off]
        off += 1
        tag = payload[off:off + tlen]
        off += tlen
        (nbytes,) = _U32.unpack_from(payload, off)
        off += _U32.size
        raw = payload[off:off + nbytes]
        off += nbytes
        if tag == OBJ_TAG:
            cols[name] = np.asarray(json.loads(raw), object)
        else:
            cols[name] = np.frombuffer(raw, np.dtype(tag.decode()), n)
    (tlen,) = _U32.unpack_from(payload, off)
    off += _U32.size
    tags = json.loads(payload[off:off + tlen])
    return found, cols, tags


def _py(v):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def values_from_columnar(found: np.ndarray, cols: Dict[str, np.ndarray]
                         ) -> List[Optional[Dict[str, Any]]]:
    """Columnar answer -> the JSON protocol's per-key value dicts (None where not
    found), through the same scalar coercion the JSON path uses — the
    binary==JSON equality bridge, and the slow-but-compatible accessor for
    callers that want dict rows off a binary response."""
    n = len(found)
    values: List[Optional[Dict[str, Any]]] = [None] * n
    if not cols:
        return values
    names = list(cols)
    lists = [cols[c].tolist() for c in names]
    for i in np.flatnonzero(np.asarray(found)).tolist():
        values[i] = {c: lst[i] for c, lst in zip(names, lists)}
    return values


def columnar_from_values(found, values: List[Optional[Dict[str, Any]]]
                         ) -> Dict[str, np.ndarray]:
    """Per-key dict rows -> dense columns (the legacy-backend fallback:
    states with no columnar read path still answer binary clients)."""
    n = len(found)
    cols: Dict[str, List[Any]] = {}
    for v in values:
        if v is not None:
            for c in v:
                cols.setdefault(c, [None] * n)
    for i, v in enumerate(values):
        if v is not None:
            for c, cv in v.items():
                cols[c][i] = cv
    out: Dict[str, np.ndarray] = {}
    for c, lst in cols.items():
        filler = [x for x in lst if x is not None]
        if filler and all(isinstance(x, (int, np.integer))
                          and not isinstance(x, bool) for x in filler):
            out[c] = np.asarray([0 if x is None else x for x in lst],
                                np.int64)
        elif filler and all(isinstance(x, (int, float, np.number))
                            and not isinstance(x, bool) for x in filler):
            out[c] = np.asarray([0.0 if x is None else x for x in lst],
                                np.float64)
        else:
            out[c] = np.asarray(lst, object)
    return out

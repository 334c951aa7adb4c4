"""CDC changelog formats: Debezium / Canal / Maxwell JSON envelopes (port
of ``flink_tpu/formats/cdc.py``).

Analog of ``flink-formats/flink-json``'s changelog deserializers —
``DebeziumJsonDeserializationSchema.java:56``,
``CanalJsonDeserializationSchema``, ``MaxwellJsonDeserializationSchema`` —
and their serialization mirrors.  Each decoder maps one external envelope
to the framework's changelog rows: plain dicts carrying the payload columns
plus an ``op`` column (``+I`` insert, ``-U``/``+U`` update
retract/replace, ``-D`` delete), exactly the row shape the retraction
runtime (``flink_tpu_torch.operators.sql_ops``) consumes and the streaming
joins/aggregates fold.

Envelope shapes handled:

- **Debezium** ``{"before": .., "after": .., "op": "c|r|u|d", ...}``;
  ``op`` c (create) and r (snapshot read) -> ``+I after``; u ->
  ``-U before`` + ``+U after``; d -> ``-D before``.
- **Canal** ``{"data": [rows], "old": [changed-cols], "type":
  "INSERT|UPDATE|DELETE"}`` — ``old[i]`` holds only the CHANGED columns of
  ``data[i]``'s previous image, so the before-row is ``data[i]`` overlaid
  with ``old[i]``.
- **Maxwell** ``{"data": row, "old": changed-cols, "type":
  "insert|update|delete"}`` — single-row variant of the Canal shape.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Union

Payload = Union[bytes, str, dict]

OP_INSERT = "+I"
OP_UPDATE_BEFORE = "-U"
OP_UPDATE_AFTER = "+U"
OP_DELETE = "-D"


def _as_dict(payload: Payload) -> dict:
    if isinstance(payload, dict):
        return payload
    if isinstance(payload, bytes):
        payload = payload.decode()
    return json.loads(payload)


def _row(op: str, data: dict) -> dict:
    out = dict(data)
    out["op"] = op
    return out


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------


def decode_debezium(payload: Payload) -> List[dict]:
    env = _as_dict(payload)
    if "payload" in env and "op" in (env.get("payload") or {}):
        env = env["payload"]    # schema-included envelope: unwrap
    op = env.get("op")
    before, after = env.get("before"), env.get("after")
    if op in ("c", "r"):
        if after is None:
            raise ValueError(f"debezium op {op!r} without 'after'")
        return [_row(OP_INSERT, after)]
    if op == "u":
        if before is None or after is None:
            raise ValueError("debezium op 'u' needs 'before' and 'after'")
        return [_row(OP_UPDATE_BEFORE, before),
                _row(OP_UPDATE_AFTER, after)]
    if op == "d":
        if before is None:
            raise ValueError("debezium op 'd' without 'before'")
        return [_row(OP_DELETE, before)]
    raise ValueError(f"unknown debezium op {op!r}")


def decode_canal(payload: Payload) -> List[dict]:
    env = _as_dict(payload)
    typ = (env.get("type") or "").upper()
    data = env.get("data") or []
    old = env.get("old") or []
    if typ == "INSERT":
        return [_row(OP_INSERT, r) for r in data]
    if typ == "DELETE":
        return [_row(OP_DELETE, r) for r in data]
    if typ == "UPDATE":
        out: List[dict] = []
        for i, r in enumerate(data):
            changed = old[i] if i < len(old) and old[i] else {}
            out.append(_row(OP_UPDATE_BEFORE, {**r, **changed}))
            out.append(_row(OP_UPDATE_AFTER, r))
        return out
    raise ValueError(f"unknown canal type {env.get('type')!r}")


def decode_maxwell(payload: Payload) -> List[dict]:
    env = _as_dict(payload)
    typ = (env.get("type") or "").lower()
    data = env.get("data") or {}
    old = env.get("old") or {}
    if typ == "insert":
        return [_row(OP_INSERT, data)]
    if typ == "delete":
        return [_row(OP_DELETE, data)]
    if typ == "update":
        return [_row(OP_UPDATE_BEFORE, {**data, **old}),
                _row(OP_UPDATE_AFTER, data)]
    raise ValueError(f"unknown maxwell type {env.get('type')!r}")


_DECODERS: Dict[str, Callable[[Payload], List[dict]]] = {
    "debezium-json": decode_debezium,
    "canal-json": decode_canal,
    "maxwell-json": decode_maxwell,
}


def cdc_decoder(fmt: str) -> Callable[[Payload], List[dict]]:
    """Decoder for a CDC format name — plugs into
    ``KafkaWireSource(value_decoder=...)``."""
    if fmt not in _DECODERS:
        raise ValueError(f"unknown CDC format {fmt!r}; "
                         f"have {sorted(_DECODERS)}")
    return _DECODERS[fmt]


# ---------------------------------------------------------------------------
# encoders (changelog rows -> external envelopes, the serialization mirror)
# ---------------------------------------------------------------------------


def _strip_op(row: dict) -> dict:
    return {k: v for k, v in row.items() if k != "op"}


def encode_debezium(rows: List[dict]) -> List[dict]:
    """Changelog rows -> debezium envelopes.  A ``-U``/``+U`` pair folds
    into ONE ``op: u`` envelope (before/after); ``-U`` without a following
    ``+U`` of the same shape encodes as a delete, matching what the
    reference's serializer emits for upsert materialization."""
    out: List[dict] = []
    i = 0
    while i < len(rows):
        r = rows[i]
        op = r.get("op", OP_INSERT)
        if op == OP_INSERT:
            out.append({"before": None, "after": _strip_op(r), "op": "c"})
        elif op == OP_DELETE:
            out.append({"before": _strip_op(r), "after": None, "op": "d"})
        elif op == OP_UPDATE_BEFORE and i + 1 < len(rows) \
                and rows[i + 1].get("op") == OP_UPDATE_AFTER:
            out.append({"before": _strip_op(r),
                        "after": _strip_op(rows[i + 1]), "op": "u"})
            i += 1
        elif op == OP_UPDATE_BEFORE:
            out.append({"before": _strip_op(r), "after": None, "op": "d"})
        elif op == OP_UPDATE_AFTER:
            out.append({"before": None, "after": _strip_op(r), "op": "c"})
        else:
            raise ValueError(f"unknown changelog op {op!r}")
        i += 1
    return out


def encode_canal(rows: List[dict]) -> List[dict]:
    out: List[dict] = []
    i = 0
    while i < len(rows):
        r = rows[i]
        op = r.get("op", OP_INSERT)
        if op == OP_INSERT:
            out.append({"data": [_strip_op(r)], "old": None,
                        "type": "INSERT"})
        elif op == OP_DELETE:
            out.append({"data": [_strip_op(r)], "old": None,
                        "type": "DELETE"})
        elif op == OP_UPDATE_BEFORE and i + 1 < len(rows) \
                and rows[i + 1].get("op") == OP_UPDATE_AFTER:
            before, after = _strip_op(r), _strip_op(rows[i + 1])
            changed = {k: v for k, v in before.items()
                       if after.get(k) != v}
            out.append({"data": [after], "old": [changed],
                        "type": "UPDATE"})
            i += 1
        else:
            raise ValueError(f"unpaired changelog op {op!r} at row {i}")
        i += 1
    return out

"""State carried across: snapshots between the JAX operator and the port.

A stream processor's "weights" are its state.  Both packages' window
operators snapshot to a dict of numpy arrays in the same dense format (the
JAX operator's mirror-sourced snapshot):

    pane_base, max_pane, last_fired_window, watermark, late_dropped, P
    key_index = {"reverse": int64[n]}, key_index_kind = "KeyIndex"
    panes int64[m], counts int32[n, m], leaves [f32[n, m], ...], leaf_schema

so :func:`snapshot_from_jax` and :func:`snapshot_to_jax` mostly validate and
fix dtypes.  A mesh snapshot's per-shard slices (``shard_slices`` with its
``shard_layout`` manifest, ``state/shard_layout.py``) cross over as slices,
each slice's arrays fixed like the dense ones.  Count-trigger registers
cross over both ways (``count_baselines``: window -> int64 ``[n]``;
``value_baselines``: window -> one array per accumulator leaf, in the leaf
dtypes).  Snapshot features this slice does not carry (incremental
increments, object keys) are refused.

The basic operators' keyed snapshots (``KeyedReduceOperator``:
``keys``/``key_index_kind``/``leaves``; ``ExtremumByOperator``:
``state.vals``/``state.rows``) cross over through
:func:`keyed_snapshot_from_jax` and :func:`keyed_snapshot_to_jax`.

Session snapshots (``SessionWindowOperator`` and its mesh subclass: raw
``session_keys``, ``start``/``end``/``fired`` per live session, ``acc`` one
array per accumulator leaf, ``watermark``, ``late_dropped``, optional
distinct ``sets``) cross over through :func:`session_snapshot_from_jax` and
:func:`session_snapshot_to_jax`; the evicting lane's
(``DeviceEvictingWindowOperator``: the pane bookkeeping, the key index and
the live raw elements ``vals`` f32, ``keys`` int32, absolute ``panes`` and
``ts`` int64) through :func:`evicting_snapshot_from_jax` and
:func:`evicting_snapshot_to_jax`.  Session accumulator leaves go to JAX in
the dtypes JAX holds them in with x64 off: a 64-bit leaf (the port's
``SumAggregator(torch.int64)``) narrows to 32 bits, as JAX would have
folded it.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from flink_tpu_torch.state.shard_layout import (LAYOUT_KEY, SLICES_KEY,
                                                densify_keyed_snapshot)

_SCALARS = ("pane_base", "max_pane", "last_fired_window", "watermark",
            "late_dropped", "P")
_REFUSED = ("__increment__",)


def _optional_int(v):
    return None if v is None else int(v)


def _normalize(snap: Dict[str, Any], source: str) -> Dict[str, Any]:
    for key in _REFUSED:
        if snap.get(key):
            raise ValueError(f"{source} snapshot carries {key!r}, which this "
                             f"slice of the port does not restore")
    missing = [k for k in ("pane_base", "max_pane", "last_fired_window",
                           "watermark", "P") if k not in snap]
    if missing:
        raise ValueError(f"{source} snapshot lacks {missing}")
    out: Dict[str, Any] = {k: _optional_int(snap.get(k, 0))
                           for k in _SCALARS}
    if "key_index" in snap:
        if snap.get("key_index_kind") != "KeyIndex":
            raise ValueError(f"{source} snapshot key index is "
                             f"{snap.get('key_index_kind')!r}; only int64 "
                             f"keys (KeyIndex) cross over in this slice")
        out["key_index"] = {"reverse": np.ascontiguousarray(
            snap["key_index"]["reverse"], np.int64)}
        out["key_index_kind"] = "KeyIndex"
    _baselines(snap, out)
    if SLICES_KEY in snap:
        # validate the slices as the dense state they tile, then carry them
        dense = _normalize(densify_keyed_snapshot(snap), source)
        out["panes"] = dense["panes"]
        out["leaf_schema"] = dense["leaf_schema"]
        out[SLICES_KEY] = [
            {"shard": int(s["shard"]),
             "row_range": tuple(int(r) for r in s["row_range"]),
             "key_groups": tuple(int(g) for g in s["key_groups"]),
             "counts": np.ascontiguousarray(s["counts"], np.int32),
             "leaves": [np.ascontiguousarray(l) for l in s["leaves"]]}
            for s in snap[SLICES_KEY]]
        out[LAYOUT_KEY] = {k: int(v) for k, v in snap[LAYOUT_KEY].items()}
        return out
    if "leaves" in snap:
        panes = np.ascontiguousarray(snap["panes"], np.int64)
        counts = np.ascontiguousarray(snap["counts"], np.int32)
        n = out["key_index"]["reverse"].size if "key_index" in out else None
        if counts.ndim != 2 or counts.shape[1] != panes.size \
                or (n is not None and counts.shape[0] != n):
            raise ValueError(f"{source} snapshot counts {counts.shape} do not "
                             f"match {panes.size} panes x {n} keys")
        leaves = [np.ascontiguousarray(l) for l in snap["leaves"]]
        for l in leaves:
            if l.shape[:2] != counts.shape:
                raise ValueError(f"{source} snapshot leaf {l.shape} does not "
                                 f"match counts {counts.shape}")
        out["panes"] = panes
        out["counts"] = counts
        out["leaves"] = leaves
        schema = snap.get("leaf_schema")
        out["leaf_schema"] = (
            [{"name": str(s["name"]), "dtype": str(s["dtype"])}
             for s in schema] if schema is not None
            else [{"name": f"[{i}]", "dtype": l.dtype.name}
                  for i, l in enumerate(leaves)])
        for s, l in zip(out["leaf_schema"], leaves):
            if np.dtype(s["dtype"]) != l.dtype:
                raise ValueError(f"{source} snapshot leaf {s['name']!r} is "
                                 f"{l.dtype}, its schema says {s['dtype']}")
    return out


def _baselines(snap: Dict[str, Any], out: Dict[str, Any]) -> None:
    """The count-trigger registers, dtypes fixed: int64 counts, and the
    value baselines in their leaf dtypes (the schema's, where the snapshot
    has one)."""
    if snap.get("count_baselines"):
        out["count_baselines"] = {
            int(w): np.ascontiguousarray(b, np.int64)
            for w, b in snap["count_baselines"].items()}
    if snap.get("value_baselines"):
        dtypes = [np.dtype(s["dtype"]) for s in snap.get("leaf_schema")
                  or ()]
        out["value_baselines"] = {
            int(w): [np.ascontiguousarray(l, dtypes[j] if j < len(dtypes)
                                          else None)
                     for j, l in enumerate(leaves)]
            for w, leaves in snap["value_baselines"].items()}


def _keyed_index(snap: Dict[str, Any], source: str) -> Dict[str, Any]:
    kind = snap.get("key_index_kind", "KeyIndex")
    if kind != "KeyIndex":
        raise ValueError(f"{source} snapshot key index is {kind!r}; only "
                         f"int64 keys (KeyIndex) cross over in this slice")
    return {"reverse": np.ascontiguousarray(snap["keys"]["reverse"],
                                            np.int64)}


def _normalize_keyed(snap: Dict[str, Any], source: str) -> Dict[str, Any]:
    if snap.get("empty", True):
        return {"empty": True}
    out: Dict[str, Any] = {"empty": False,
                           "keys": _keyed_index(snap, source),
                           "key_index_kind": "KeyIndex"}
    n = out["keys"]["reverse"].size
    if "leaves" in snap:
        out["leaves"] = [np.ascontiguousarray(l) for l in snap["leaves"]]
        rows = [l.shape[0] for l in out["leaves"]]
    else:
        out["state.vals"] = np.ascontiguousarray(snap["state.vals"],
                                                 np.float64)
        out["state.rows"] = np.asarray(snap["state.rows"], object)
        rows = [out["state.vals"].shape[0], out["state.rows"].shape[0]]
    if any(r != n for r in rows):
        raise ValueError(f"{source} keyed snapshot rows {rows} do not match "
                         f"{n} keys")
    return out


def keyed_snapshot_from_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX basic operator's keyed snapshot (``KeyedReduceOperator``,
    ``ExtremumByOperator``) -> the port's format."""
    return _normalize_keyed(snap, "JAX")


def keyed_snapshot_to_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A port basic operator's keyed snapshot -> the JAX operator's."""
    return _normalize_keyed(snap, "port")


def snapshot_from_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX ``WindowAggOperator.snapshot_state()`` dict -> the port's
    format (ready for the port's ``restore_state``)."""
    return _normalize(snap, "JAX")


def snapshot_to_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A port ``WindowAggOperator.snapshot_state()`` dict -> the JAX
    operator's format (ready for its ``restore_state``)."""
    return _normalize(snap, "port")


#: 64-bit dtypes and the 32-bit ones JAX stores them as with x64 off
_X64_OFF = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
            np.dtype(np.uint64): np.uint32}


def _normalize_session(snap: Dict[str, Any], source: str,
                       x64_off: bool = False) -> Dict[str, Any]:
    keys = np.ascontiguousarray(snap.get("session_keys", ()), np.int64)
    n = keys.size
    out: Dict[str, Any] = {
        "session_keys": keys,
        "start": np.ascontiguousarray(snap.get("start", ()), np.int64),
        "end": np.ascontiguousarray(snap.get("end", ()), np.int64),
        "fired": np.ascontiguousarray(snap.get("fired", ()), bool),
        "watermark": int(snap.get("watermark", -(2 ** 63))),
        "late_dropped": int(snap.get("late_dropped", 0)),
    }
    acc = [np.asarray(a) for a in snap.get("acc", ())]
    if x64_off:
        acc = [a.astype(_X64_OFF.get(a.dtype, a.dtype), copy=False)
               for a in acc]
    out["acc"] = tuple(np.ascontiguousarray(a) for a in acc)
    rows = [out[f].shape[0] for f in ("start", "end", "fired")] + [
        a.shape[0] for a in out["acc"]]
    if "sets" in snap:
        out["sets"] = [list(s) for s in snap["sets"]]
        rows.append(len(out["sets"]))
    if any(r != n for r in rows):
        raise ValueError(f"{source} session snapshot rows {rows} do not "
                         f"match {n} session keys")
    return out


def session_snapshot_from_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX session operator's snapshot -> the port's format (a restore
    casts each leaf into the port's accumulator dtype)."""
    return _normalize_session(snap, "JAX")


def session_snapshot_to_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A port session operator's snapshot -> the JAX operator's format, its
    64-bit accumulator leaves narrowed as JAX holds them with x64 off."""
    return _normalize_session(snap, "port", x64_off=True)


def _normalize_evicting(snap: Dict[str, Any], source: str) -> Dict[str, Any]:
    missing = [k for k in ("pane_base", "max_pane", "last_fired_window",
                           "watermark") if k not in snap]
    if missing:
        raise ValueError(f"{source} evicting snapshot lacks {missing}")
    out: Dict[str, Any] = {k: _optional_int(snap[k])
                           for k in ("pane_base", "max_pane",
                                     "last_fired_window", "watermark")}
    out["late_dropped"] = int(snap.get("late_dropped", 0))
    if "key_index" in snap:
        if snap.get("key_index_kind") != "KeyIndex":
            raise ValueError(f"{source} snapshot key index is "
                             f"{snap.get('key_index_kind')!r}; only int64 "
                             f"keys (KeyIndex) cross over in this slice")
        out["key_index"] = {"reverse": np.ascontiguousarray(
            snap["key_index"]["reverse"], np.int64)}
        out["key_index_kind"] = "KeyIndex"
    if "vals" in snap:
        cols = {"vals": np.float32, "keys": np.int32, "panes": np.int64,
                "ts": np.int64}
        for k, dt in cols.items():
            out[k] = np.ascontiguousarray(snap[k], dt)
        rows = {k: out[k].shape for k in cols}
        if len(set(rows.values())) != 1 or out["vals"].ndim != 1:
            raise ValueError(f"{source} evicting snapshot columns {rows} "
                             f"differ")
    return out


def evicting_snapshot_from_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX ``DeviceEvictingWindowOperator`` snapshot -> the port's."""
    return _normalize_evicting(snap, "JAX")


def evicting_snapshot_to_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A port ``DeviceEvictingWindowOperator`` snapshot -> JAX's."""
    return _normalize_evicting(snap, "port")

"""State carried across: snapshots between the JAX operator and the port.

A stream processor's "weights" are its state.  Both packages' window
operators snapshot to a dict of numpy arrays in the same dense format (the
JAX operator's mirror-sourced snapshot):

    pane_base, max_pane, last_fired_window, watermark, late_dropped, P
    key_index = {"reverse": int64[n]}, key_index_kind = "KeyIndex"
    panes int64[m], counts int32[n, m], leaves [f32[n, m], ...], leaf_schema

so :func:`snapshot_from_jax` and :func:`snapshot_to_jax` mostly validate and
fix dtypes.  Snapshot features this slice does not carry (sharded slices,
count-trigger baselines, incremental increments, object keys) are refused.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

_SCALARS = ("pane_base", "max_pane", "last_fired_window", "watermark",
            "late_dropped", "P")
_REFUSED = ("shard_slices", "shard_layout", "count_baselines",
            "value_baselines", "__increment__")


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


def snapshot_from_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX ``WindowAggOperator.snapshot_state()`` dict -> the port's
    format (ready for the port's ``restore_state``)."""
    return _normalize(snap, "JAX")


def snapshot_to_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A port ``WindowAggOperator.snapshot_state()`` dict -> the JAX
    operator's format (ready for its ``restore_state``)."""
    return _normalize(snap, "port")

"""Key-group state redistribution: rescale keyed snapshots (the keyed half
of ``flink_tpu/state/redistribute.py``).

The analog of ``StateAssignmentOperation.java`` (``reDistributeKeyedStates``,
``createKeyGroupPartitions``): on restore at another parallelism each new
subtask receives exactly the rows whose key group falls in its range.  It
works on the keyed snapshot convention of the window operator: a
``key_index`` snapshot (slot -> raw key) plus row arrays aligned with the
slot ids, so a split is a mask and a row selection, a merge a concatenation
and a re-index.  The channel-state half of the JAX module belongs with the
runtime stack.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from flink_tpu_torch.core import keygroups
from flink_tpu_torch.state.keyindex import KeyIndex, ObjectKeyIndex


def _restore_index(snap: Dict[str, Any]):
    cls = (ObjectKeyIndex if snap.get("key_index_kind") == "ObjectKeyIndex"
           else KeyIndex)
    return cls.restore(snap["key_index"] if "key_index" in snap
                       else snap["keys"])


def _index_snapshot_of(keys: np.ndarray, kind: str):
    """A fresh index of ``kind`` over ``keys``: (its snapshot,
    ``row_order``), where ``row_order[slot]`` is the position in ``keys``
    that owns the slot (row arrays are permuted by it to stay
    slot-aligned)."""
    idx = ObjectKeyIndex() if kind == "ObjectKeyIndex" else KeyIndex()
    n = len(keys)
    if n:
        slots = idx.lookup_or_insert(np.asarray(keys))
        row_order = np.empty(n, np.int64)
        row_order[slots] = np.arange(n)
    else:
        row_order = np.zeros(0, np.int64)
    return idx.snapshot(), row_order


def _row_select(value, sel: np.ndarray):
    if isinstance(value, (list, tuple)):
        out = [np.asarray(v)[sel] for v in value]
        return type(value)(out) if isinstance(value, tuple) else out
    return np.asarray(value)[sel]


def _row_concat(values: List[Any]):
    first = values[0]
    if isinstance(first, (list, tuple)):
        out = [np.concatenate([np.asarray(v[i]) for v in values])
               for i in range(len(first))]
        return type(first)(out) if isinstance(first, tuple) else out
    return np.concatenate([np.asarray(v) for v in values])


def split_keyed_snapshot(snap: Dict[str, Any], row_fields: Sequence[str],
                         max_parallelism: int,
                         new_parallelism: int) -> List[Dict[str, Any]]:
    """One keyed snapshot -> ``new_parallelism`` snapshots, rows routed by
    key-group range (the ranges the runtime assigns subtasks)."""
    if snap.get("empty") or "key_index" not in snap and "keys" not in snap:
        return [dict(snap) for _ in range(new_parallelism)]
    idx = _restore_index(snap)
    keys = np.asarray(idx.reverse_keys())
    kind = snap.get("key_index_kind", "KeyIndex")
    kg = keygroups.assign_to_key_group(keygroups.hash_keys(keys),
                                       max_parallelism)
    ranges = keygroups.key_group_ranges(max_parallelism, new_parallelism)
    out = []
    for r in ranges:
        sel = np.nonzero((kg >= r.start) & (kg <= r.end))[0]
        sub = dict(snap)
        key_field = "key_index" if "key_index" in snap else "keys"
        idx_snap, row_order = _index_snapshot_of(keys[sel], kind)
        sub[key_field] = idx_snap
        sub["key_index_kind"] = kind
        rows = sel[row_order]  # original row per new slot
        for f in row_fields:
            if f in snap and snap[f] is not None:
                sub[f] = _row_select(snap[f], rows)
        out.append(sub)
    return out


def merge_keyed_snapshots(snaps: Sequence[Dict[str, Any]],
                          row_fields: Sequence[str]) -> Dict[str, Any]:
    """Inverse of :func:`split_keyed_snapshot` (scale-down)."""
    live = [s for s in snaps
            if not s.get("empty") and ("key_index" in s or "keys" in s)]
    if not live:
        return dict(snaps[0]) if snaps else {"empty": True}
    key_field = "key_index" if "key_index" in live[0] else "keys"
    keys = np.concatenate([np.asarray(_restore_index(s).reverse_keys())
                           for s in live])
    kind = live[0].get("key_index_kind", "KeyIndex")
    merged = dict(live[0])
    idx_snap, row_order = _index_snapshot_of(keys, kind)
    merged[key_field] = idx_snap
    merged["key_index_kind"] = kind
    for f in row_fields:
        if f in live[0] and live[0][f] is not None:
            merged[f] = _row_select(_row_concat([s[f] for s in live]),
                                    row_order)
    return merged

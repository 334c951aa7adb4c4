"""Key-group state redistribution: rescale keyed snapshots (the keyed half
of ``flink_tpu/state/redistribute.py``).

The analog of ``StateAssignmentOperation.java`` (``reDistributeKeyedStates``,
``createKeyGroupPartitions``): on restore at another parallelism each new
subtask receives exactly the rows whose key group falls in its range.  It
works on the keyed snapshot convention of the window operator: a
``key_index`` snapshot (slot -> raw key) plus row arrays aligned with the
slot ids, so a split is a mask and a row selection, a merge a concatenation
and a re-index.

The channel-state half (:func:`reject_channel_state`,
:func:`redistribute_channel_state`: an unaligned checkpoint's persisted
in-flight batches re-routed by their own keys) and the snapshot-kind table
(:func:`snapshot_operator_class`, shared by the savepoint merge) are the JAX
module's, pointed at the port's operators.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from flink_tpu_torch.core import keygroups
from flink_tpu_torch.core.batch import RecordBatch
from flink_tpu_torch.state.keyindex import KeyIndex, ObjectKeyIndex


#: channel-state snapshot section versions this runtime reads.  v1 (PR 5)
#: records elements keyed by physical channel index only; v2 additionally
#: records per-input routing metadata (key column, partitioning, producer
#: max-parallelism, logical port), which is what makes rescale-time
#: redistribution possible.  Unknown versions still fail loudly.
CHANNEL_STATE_VERSIONS = (1, 2)
#: the version new snapshots are written at
CHANNEL_STATE_WRITE_VERSION = 2


class ChannelStateRescaleError(RuntimeError):
    """A snapshot carrying persisted in-flight CHANNEL STATE (an unaligned
    checkpoint) was handed to a path that cannot redistribute it.  v2
    sections (this runtime's write format) carry the per-input routing
    metadata needed to re-route each persisted element by its own key, so
    keyed rescale proceeds; a legacy v1 section with non-empty elements
    has no routing metadata — for those the supported procedure is still
    drain-then-rescale: take an ALIGNED savepoint (stop-with-savepoint, or
    let one aligned periodic checkpoint complete) and rescale from that."""


def reject_channel_state(snapshot, context: str) -> None:
    """Fail LOUDLY if any subtask snapshot in a job checkpoint carries
    non-empty unaligned channel state — paths that cannot redistribute
    (e.g. offline merges) must never silently drop or misroute persisted
    in-flight elements.  ``snapshot`` is the MiniCluster/ProcessCluster
    layout ``{uid: {"subtasks": [...]}}``.  The keyed RESCALE path no
    longer calls this: it redistributes v2 sections by record key
    (:func:`redistribute_channel_state`)."""
    if not isinstance(snapshot, dict):
        return
    for uid, entry in snapshot.items():
        if uid.startswith("__") or not isinstance(entry, dict):
            continue
        for idx, sub in enumerate(entry.get("subtasks", []) or []):
            if not isinstance(sub, dict):
                continue
            cs = sub.get("channel_state")
            elements = (cs.get("elements", []) if isinstance(cs, dict)
                        else cs)
            if elements:
                raise ChannelStateRescaleError(
                    f"{context}: subtask {uid}[{idx}] snapshot carries "
                    f"{len(elements)} persisted in-flight channel-state "
                    f"elements (unaligned checkpoint) — this path cannot "
                    f"redistribute channel state; drain-then-rescale: "
                    f"use an ALIGNED savepoint instead")


# ---------------------------------------------------------------------------
# channel-state redistribution (the FLIP-76 follow-on: rescale restores of
# unaligned checkpoints re-route persisted in-flight elements by KEY)
# ---------------------------------------------------------------------------

def _route_batch(el, info, new_parallelism: int):
    """One persisted in-flight RecordBatch -> ``[(target, sub_batch)]``,
    routed by the RECORD'S OWN KEY exactly the way the producing edge's
    dispatcher routes live batches: the batch's own ``key_groups`` when
    the upstream keying attached them, else the edge's key column hashed
    with the producer's max-parallelism (``KeyGroupStreamPartitioner``),
    then ``kg * P' // maxp`` — the same assignment
    ``core.keygroups.route_raw_keys`` computes.  Returns None when the
    element is not key-routable (non-keyed edge, no key metadata)."""
    kg = getattr(el, "key_groups", None)
    maxp = int(info.get("max_parallelism", 128)) if info else 128
    if kg is None:
        if not info or info.get("partitioning") != "hash" \
                or info.get("key_column") is None:
            return None
        keys = np.asarray(el.column(info["key_column"]))
        kg = keygroups.assign_to_key_group(keygroups.hash_keys(keys), maxp)
    target = (np.asarray(kg, np.int64) * new_parallelism) // maxp
    out = []
    for t in range(new_parallelism):
        sel = target == t
        if sel.any():
            out.append((int(t), el.select(sel)))
    return out


def redistribute_channel_state(sections, new_parallelism: int,
                               context: str = "rescale"):
    """Persisted in-flight channel state across a parallelism change.

    ``sections``: the old subtasks' channel-state snapshot sections (one
    per old subtask, subtask order; None/missing entries allowed).
    Returns ``new_parallelism`` v2 sections whose elements are keyed by
    LOGICAL input port (``by_logical_port``): on restore each element
    replays into the first input channel of its port, BEFORE any new
    input — the same ordering contract same-parallelism restore has.

    Routing: each persisted RecordBatch splits row-wise by the record's
    own key into the new key-group ranges (``_route_batch``); non-keyed
    batches, watermarks and every other in-flight element replay on the
    downstream's subtask 0.  Ordering is deterministic: old subtasks in
    index order, each section's elements in recorded order, and a split
    batch's per-target slices preserve row order — so any one new
    subtask sees its share of the in-flight stream in the original
    relative order.

    Output sections are themselves re-redistributable: each carries an
    ``inputs`` list indexed by LOGICAL PORT with the original edges'
    routing metadata (key column, partitioning, producer
    max-parallelism), so a second pass — e.g. restoring a rewritten
    savepoint at yet another parallelism — routes every element exactly
    as the first did.  (Two edges sharing one logical port keep the
    first edge's metadata; batches that carry ``key_groups`` route by
    them regardless.)

    A legacy v1 section (no per-input routing metadata) with non-empty
    elements raises :class:`ChannelStateRescaleError` — old snapshots
    stay readable at the SAME parallelism, but keyed redistribution
    needs the v2 metadata."""
    out_elements = [[] for _ in range(new_parallelism)]
    port_infos: Dict[int, Dict[str, Any]] = {}
    unaligned = False
    align_ms = 0.0
    overtaken_total = 0
    for idx, sec in enumerate(sections):
        if not isinstance(sec, dict):
            if sec:
                raise ChannelStateRescaleError(
                    f"{context}: subtask {idx} carries a legacy bare-list "
                    f"channel-state section ({len(sec)} elements) — no "
                    f"routing metadata; drain-then-rescale instead")
            continue
        version = sec.get("version")
        elements = list(sec.get("elements", []))
        unaligned |= bool(sec.get("unaligned"))
        align_ms = max(align_ms, float(sec.get("alignment_ms", 0.0)))
        overtaken_total += int(sec.get("overtaken_bytes", 0))
        if not elements:
            continue
        if version not in CHANNEL_STATE_VERSIONS:
            raise ValueError(
                f"{context}: unknown channel-state snapshot version "
                f"{version!r} (this runtime reads "
                f"{list(CHANNEL_STATE_VERSIONS)})")
        if version < 2:
            raise ChannelStateRescaleError(
                f"{context}: subtask {idx} snapshot carries "
                f"{len(elements)} persisted in-flight elements in a v1 "
                f"channel-state section — v1 has no per-input routing "
                f"metadata, so it cannot be redistributed across "
                f"parallelisms; drain-then-rescale (ALIGNED savepoint), "
                f"or re-checkpoint on a v2 runtime first")
        inputs = sec.get("inputs") or []
        for i, el in elements:
            # in an already-redistributed section ``i`` IS the logical
            # port and ``inputs`` is port-indexed — the same lookup works
            info = inputs[i] if isinstance(i, int) and i < len(inputs) \
                and inputs[i] else None
            port = (int(info.get("logical", i if sec.get("by_logical_port")
                                  else 0)) if info
                    else (int(i) if sec.get("by_logical_port") else 0))
            if info and port not in port_infos:
                port_infos[port] = dict(info, logical=port)
            routed = (_route_batch(el, info, new_parallelism)
                      if el.is_batch() and len(el) else None)
            if routed is None:
                # non-keyed / broadcast in-flight element (or a control
                # element like a watermark): downstream subtask 0
                out_elements[0].append((port, el))
            else:
                for t, sub in routed:
                    out_elements[t].append((port, sub))
    max_port = max(port_infos, default=-1)
    port_inputs = [port_infos.get(p, {}) for p in range(max_port + 1)]
    out = []
    for t, els in enumerate(out_elements):
        persisted = sum(element_bytes(el) for _p, el in els)
        out.append({"version": CHANNEL_STATE_WRITE_VERSION,
                    "elements": els,
                    "by_logical_port": True,
                    "inputs": [dict(pi) for pi in port_inputs],
                    "persisted_bytes": int(persisted),
                    # the REAL overtake accounting of the input sections,
                    # carried on subtask 0 only so job-level sums (which
                    # add across subtasks) stay exact
                    "overtaken_bytes": overtaken_total if t == 0 else 0,
                    "alignment_ms": align_ms,
                    "unaligned": unaligned})
    return out


#: snapshot-kind dispatch shared by the rescale split and the savepoint
#: merge (``state_processor/savepoint._merge_keyed_group``): ONE ordered
#: marker-key -> operator-class table, so a member's split and merge can
#: never dispatch to different operators.  First matching marker wins.
_SNAPSHOT_KINDS: Tuple[Tuple[str, str, str], ...] = (
    ("pane_base", "flink_tpu_torch.operators.window_agg", "WindowAggOperator"),
    ("session_keys", "flink_tpu_torch.operators.session_window",
     "SessionWindowOperator"),
    ("nfas", "flink_tpu_torch.cep.operator", "CepOperator"),
    ("two_phase", "flink_tpu_torch.connectors.sinks", "TwoPhaseCommitSink"),
)


def snapshot_operator_class(member: Any):
    """The operator class owning this member snapshot's rescale
    ``split_snapshot``/``merge_snapshots`` pair, or None for generic
    keyed / opaque members.  Imports lazily (operators must stay
    importable without this module's callers)."""
    import importlib

    if not isinstance(member, dict):
        return None
    for key, mod, cls in _SNAPSHOT_KINDS:
        if key in member:
            return getattr(importlib.import_module(mod), cls)
    return None


def element_bytes(el) -> int:
    """Approximate wire size of one stream element (a RecordBatch's column
    nbytes; a control element a small constant): the unit of the channel
    state's persisted-bytes accounting (``cluster/channels.py``'s in the
    JAX package)."""
    if isinstance(el, RecordBatch):
        total = 0
        for name in el.columns:
            nbytes = getattr(el.column(name), "nbytes", None)
            total += int(nbytes) if nbytes is not None else 8 * len(el)
        return max(total, 16)
    return 16


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

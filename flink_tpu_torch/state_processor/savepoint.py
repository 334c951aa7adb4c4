"""State Processor API: read / bootstrap / modify savepoints offline.

Analog of ``flink-libraries/flink-state-processing-api``
(``Savepoint.load(...)``, ``WindowReader.java``, ``SavepointWriter``):
checkpoints/savepoints become DataSets — list the operators, read any
operator's keyed state as rows, read WindowAggOperator pane state, rewrite
or bootstrap state from a DataSet, and write a new restorable savepoint.

Handles both snapshot layouts: the LocalExecutor's ``{uid: op_snapshot}``
and the MiniCluster's ``{uid: {"subtasks": [op_snapshot, ...]}}`` (subtask
snapshots are merged through the key-group redistribute path on read).

The port's copy of ``flink_tpu/state_processor/savepoint.py``: keyed state
reads through the port's ``HeapKeyedStateBackend``, window state through
the port's mesh densify (``state/shard_layout.py``) and key indexes, and a
merge dispatches through the port's ``state/redistribute.py``.  The
DataSets a reader returns live in an environment on the reader's
``device`` (``None``: the card, which a DataSet touches only in a device
join).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from flink_tpu_torch import DeviceLike
from flink_tpu_torch.state.heap import HeapKeyedStateBackend
from flink_tpu_torch.state.redistribute import (merge_keyed_snapshots,
                                                snapshot_operator_class)


def _is_subtask_layout(entry: Any) -> bool:
    return isinstance(entry, dict) and "subtasks" in entry


def _is_keyed(o: Any) -> bool:
    return isinstance(o, dict) and ("key_index" in o or "keys" in o)


def _is_mergeable(o: Any) -> bool:
    """Does this member snapshot have a rescale-aware merge?  Beyond the
    generic keyed layout, every kind in the shared dispatch table
    (window aggregate, session windows, CEP per-key state,
    two-phase-commit sinks) merges consistently across subtasks."""
    return _is_keyed(o) or snapshot_operator_class(o) is not None


def _merge_keyed_group(ops: List[Dict[str, Any]]) -> Dict[str, Any]:
    # empty members (a fresh subtask with no state yet) contribute
    # nothing; dispatch through the SAME kind table the rescale split
    # uses (state/redistribute.snapshot_operator_class), so a member's
    # split and merge can never land on different operators
    ops = [o for o in ops if isinstance(o, dict) and o] or list(ops)
    for o in ops:
        cls = snapshot_operator_class(o)
        if cls is not None:
            return cls.merge_snapshots(ops)
    fields = sorted({f for o in ops for f in o
                     if f.startswith("state.") or f == "leaves"})
    return merge_keyed_snapshots(ops, fields)


def _merged_operator_snapshot(entry: Any, strict: bool = False
                              ) -> Dict[str, Any]:
    """Merge one vertex's subtask snapshots into a single-operator view.

    ``strict=True`` (the RESCALE path) propagates keyed-member merge
    failures: silently keeping subtask 0's copy there would drop every
    other subtask's state from the redeployed job — a quiet
    exactly-once violation.  The default stays best-effort for offline
    savepoint READS, where a heterogeneous member is merely unreadable,
    not redeployed."""
    if not _is_subtask_layout(entry):
        return entry
    subs = [s for s in entry["subtasks"] if s is not None]
    ops = [s.get("operator", s) for s in subs]
    if not ops:
        return {}
    if all(_is_mergeable(o) for o in ops):
        return _merge_keyed_group(ops)
    # chained vertex: merge the mergeable chain members across subtasks,
    # best-effort (other non-keyed members keep subtask 0's copy); empty
    # members (a subtask that held no state for this member yet) are
    # compatible with any mergeable sibling
    member_keys = [k for k in ops[0]
                   if k.startswith("op") and k[2:].isdigit()]
    if member_keys and all(set(member_keys) <= set(o) for o in ops
                           if isinstance(o, dict)):
        out = dict(ops[0])
        for mk in member_keys:
            members = [o[mk] for o in ops]
            live = [m for m in members
                    if isinstance(m, dict) and m]
            if live and all(_is_mergeable(m) for m in live):
                try:
                    out[mk] = _merge_keyed_group(members)
                except (ValueError, KeyError, IndexError):
                    if strict:
                        raise
                    pass  # heterogeneous member layout: keep subtask 0
        return out
    return ops[0]


class Savepoint:
    """``Savepoint.load`` analog."""

    @staticmethod
    def load(storage, checkpoint_id: Optional[int] = None,
             device: DeviceLike = None) -> "SavepointReader":
        snap = (storage.load(checkpoint_id) if checkpoint_id is not None
                else storage.load_latest())
        if snap is None:
            raise ValueError("no checkpoint found in storage")
        return SavepointReader(snap, device)

    @staticmethod
    def from_snapshot(snapshot: Dict[str, Any],
                      device: DeviceLike = None) -> "SavepointReader":
        return SavepointReader(snapshot, device)


def _chain_members(op_snap: Dict[str, Any]):
    """A chained vertex snapshot nests member snapshots under op0/op1/...;
    yield the vertex snapshot itself plus every chain member."""
    yield op_snap
    for k in sorted(op_snap):
        if k.startswith("op") and k[2:].isdigit() and isinstance(op_snap[k], dict):
            yield op_snap[k]


def _find_member(op_snap: Dict[str, Any], *fields: str) -> Optional[Dict[str, Any]]:
    for m in _chain_members(op_snap):
        if any(f in m for f in fields):
            return m
    return None


class SavepointReader:
    def __init__(self, snapshot: Dict[str, Any], device: DeviceLike = None):
        self.snapshot = snapshot
        #: the device of the environment of every DataSet read
        self.device = device

    def operator_uids(self) -> List[str]:
        return sorted(u for u in self.snapshot
                      if not u.startswith("__"))

    def raw(self, uid: str) -> Dict[str, Any]:
        return _merged_operator_snapshot(self.snapshot[uid])

    # -- keyed state ---------------------------------------------------------
    def _keyed_member(self, uid: str) -> Dict[str, Any]:
        snap = self.raw(uid)
        op_snap = snap.get("operator", snap) if isinstance(snap, dict) else snap
        m = _find_member(op_snap, "key_index", "keys")
        if m is None:
            raise ValueError(f"{uid}: no keyed state in snapshot")
        return m

    def _backend_for(self, uid: str) -> HeapKeyedStateBackend:
        member = dict(self._keyed_member(uid))
        member.pop("timers", None)
        if "key_index" not in member and "keys" in member:
            # operators like KeyedReduce store the index under "keys"
            member["key_index"] = member.pop("keys")
        be = HeapKeyedStateBackend()
        be.restore(member)
        return be

    def keyed_state_names(self, uid: str) -> List[str]:
        return sorted(self._keyed_member(uid).get("state_names", []))

    def read_keyed_state(self, uid: str, state_name: str,
                         descriptor=None):
        """All (key, value) rows of one named state as a DataSet
        (``Savepoint.readKeyedState`` analog)."""
        from flink_tpu_torch.dataset import ExecutionEnvironment
        from flink_tpu_torch.state.api import ValueStateDescriptor

        be = self._backend_for(uid)
        n = be.num_keys
        env = ExecutionEnvironment(device=self.device)
        if n == 0:
            return env.from_columns({"key": np.zeros(0, np.int64),
                                     "value": np.zeros(0)})
        desc = descriptor or ValueStateDescriptor(state_name)
        st = be.get_state(desc)
        slots = np.arange(n)
        keys = be.slot_keys(slots)
        got = st.get_rows(slots)
        if isinstance(got, tuple):       # (values, alive) states
            vals, alive = got
            keys, vals = np.asarray(keys)[alive], np.asarray(vals)[alive]
        else:
            vals = got
        return env.from_columns({"key": np.asarray(keys),
                                 "value": np.asarray(vals, dtype=object)
                                 if isinstance(vals, list) else np.asarray(vals)})

    # -- window state (WindowReader analog) ----------------------------------
    def read_window_state(self, uid: str):
        """WindowAggOperator pane state as rows (key, pane, acc leaves) —
        ``WindowReader`` reads WindowOperator state offline the same way."""
        from flink_tpu_torch.dataset import ExecutionEnvironment
        from flink_tpu_torch.state.keyindex import KeyIndex, ObjectKeyIndex

        snap = self.raw(uid)
        root = snap.get("operator", snap)
        op_snap = _find_member(root, "leaves", "shard_slices")
        if op_snap is None:
            raise ValueError(f"{uid}: not a window-aggregate snapshot "
                             f"(fields: {sorted(root)[:8]})")
        # mesh snapshots carry per-shard slices with key-group manifests
        # (state/shard_layout) instead of dense arrays: merge first
        from flink_tpu_torch.state.shard_layout import densify_keyed_snapshot
        op_snap = densify_keyed_snapshot(op_snap)
        cls = (ObjectKeyIndex if op_snap.get("key_index_kind") == "ObjectKeyIndex"
               else KeyIndex)
        idx = cls.restore(op_snap["key_index"])
        keys = idx.reverse_keys()
        counts = np.asarray(op_snap["counts"])          # [K, n_live_panes]
        leaves = [np.asarray(l) for l in op_snap["leaves"]]
        panes_arr = np.asarray(op_snap["panes"], np.int64)
        k_ids, pcols = np.nonzero(counts > 0)
        cols: Dict[str, Any] = {
            "key": np.asarray(keys)[k_ids],
            "pane": panes_arr[pcols],
            "count": counts[k_ids, pcols],
        }
        for i, leaf in enumerate(leaves):
            cols[f"acc{i}"] = leaf[k_ids, pcols]
        env = ExecutionEnvironment(device=self.device)
        return env.from_columns(cols)

    # -- sources -------------------------------------------------------------
    def read_source_positions(self) -> Dict[str, Dict[str, Any]]:
        out = dict(self.snapshot.get("__sources__", {}))
        for uid, entry in self.snapshot.items():
            if _is_subtask_layout(entry):
                offs = {f"{i}": s.get("source_offset")
                        for i, s in enumerate(entry["subtasks"])
                        if s and "source_offset" in s}
                if offs:
                    out[uid] = offs
        return out


class SavepointWriter:
    """Bootstrap/modify savepoints (``SavepointWriter``/``Savepoint.create``)."""

    def __init__(self, base: Optional[Dict[str, Any]] = None):
        self.snapshot: Dict[str, Any] = dict(base or {})

    @staticmethod
    def new_savepoint() -> "SavepointWriter":
        return SavepointWriter()

    @staticmethod
    def from_existing(reader: SavepointReader) -> "SavepointWriter":
        return SavepointWriter(reader.snapshot)

    def remove_operator(self, uid: str) -> "SavepointWriter":
        self.snapshot.pop(uid, None)
        return self

    def with_keyed_state(self, uid: str, dataset, key_column: str,
                         value_column: str, state_name: str,
                         descriptor=None) -> "SavepointWriter":
        """Bootstrap one ValueState from a DataSet of (key, value) rows
        (``KeyedStateBootstrapFunction`` analog, vectorized)."""
        from flink_tpu_torch.state.api import ValueStateDescriptor

        b = dataset.collect_batch()
        be = HeapKeyedStateBackend()
        desc = descriptor or ValueStateDescriptor(state_name)
        st = be.get_state(desc)
        keys = np.asarray(b.column(key_column))
        slots = be.key_slots(keys)
        st.put_rows(slots, np.asarray(b.column(value_column)))
        self.snapshot[uid] = be.snapshot()
        return self

    def transform_keyed_state(self, uid: str, state_name: str,
                              fn, descriptor=None) -> "SavepointWriter":
        """Rewrite every (key, value) through ``fn(key, value) -> value``."""
        from flink_tpu_torch.state.api import ValueStateDescriptor

        # never mutate the caller's snapshot tree (from_existing shares it)
        import copy as _copy
        self.snapshot[uid] = _copy.deepcopy(self.snapshot[uid])
        entry = self.snapshot[uid]
        # an UNALIGNED checkpoint's persisted in-flight channel state must
        # survive the offline rewrite even though the merge collapses the
        # subtask snapshots: redistribute it to a SINGLE logical subtask
        # (the merged layout's parallelism) — restoring the rewritten
        # savepoint re-splits it by key through the rescale path.  Legacy
        # v1 sections with elements still fail loudly (no routing
        # metadata), never silently drop.
        carried_cs = None
        if _is_subtask_layout(entry):
            from flink_tpu_torch.state.redistribute import (
                redistribute_channel_state)
            sections = [(s or {}).get("channel_state")
                        for s in entry["subtasks"]]
            if any((cs.get("elements") if isinstance(cs, dict) else cs)
                   for cs in sections):
                carried_cs = redistribute_channel_state(
                    sections, 1, context="savepoint transform")[0]
        # strict: the rewritten savepoint REDEPLOYS — a keyed member that
        # cannot merge must fail the rewrite, not silently keep only
        # subtask 0's key-group ranges
        op_snap = _merged_operator_snapshot(entry, strict=True)
        inner = op_snap.get("operator", op_snap)
        member = _find_member(inner, "key_index", "keys")
        if member is None:
            raise ValueError(f"{uid}: no keyed state to transform")
        if not any(k.startswith(f"state.{state_name}.") for k in member):
            raise ValueError(
                f"{uid}: no heap state named {state_name!r} in the snapshot "
                f"(fields: {sorted(member)[:8]}); operators that keep state "
                f"in dense row fields (e.g. keyed reduce 'leaves') are not "
                f"transformable via transform_keyed_state")
        restorable = {k: v for k, v in member.items() if k != "timers"}
        if "key_index" not in restorable and "keys" in restorable:
            restorable["key_index"] = restorable.pop("keys")
        be = HeapKeyedStateBackend()
        be.restore(restorable)
        desc = descriptor or ValueStateDescriptor(state_name)
        st = be.get_state(desc)
        n = be.num_keys
        slots = np.arange(n)
        keys = be.slot_keys(slots)
        got = st.get_rows(slots)
        vals, alive = got if isinstance(got, tuple) else (got, np.ones(n, bool))
        new_vals = [fn(k, v) if a else v
                    for k, v, a in zip(np.asarray(keys).tolist(), list(vals),
                                       np.asarray(alive).tolist())]
        st.put_rows(slots, new_vals)
        new_snap = be.snapshot()
        # non-backend member fields (timers, watermarks) must survive the
        # rewrite — dropping them would silently cancel pending timers
        for k, v in member.items():
            if k not in new_snap and not k.startswith("state."):
                new_snap[k] = v
        if member is inner:
            if "operator" in op_snap:
                op_snap = dict(op_snap)
                op_snap["operator"] = new_snap
                self.snapshot[uid] = op_snap
            else:
                self.snapshot[uid] = new_snap
        else:
            member.clear()
            member.update(new_snap)
            self.snapshot[uid] = op_snap
        if carried_cs is not None:
            # merged-to-parallelism-1 subtask layout: the rewritten state
            # plus the redistributed in-flight elements; restore at any
            # parallelism goes through maybe_rescale_restore/rescale_snapshot
            rewritten = self.snapshot[uid]
            sub = (rewritten if isinstance(rewritten, dict)
                   and "operator" in rewritten
                   else {"operator": rewritten, "valve": None})
            sub["channel_state"] = carried_cs
            self.snapshot[uid] = {"subtasks": [sub]}
        return self

    def write(self, storage, checkpoint_id: int = 1) -> Dict[str, Any]:
        storage.store(checkpoint_id, self.snapshot)
        return self.snapshot

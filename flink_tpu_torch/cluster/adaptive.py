"""The restore guard of adaptive scheduling (port of the restore half of
``flink_tpu/cluster/adaptive.py``).

A MiniCluster deploy restores through :func:`maybe_rescale_restore`: when
a snapshot's recorded subtask counts differ from what the plan deploys,
:func:`rescale_snapshot` redistributes it (keyed state by key-group range,
``StateAssignmentOperation.reDistributeKeyedStates``, and persisted
in-flight channel state by each record's own key) instead of restoring it
positionally.  Sources must have stable splits (split count independent of
the job's parallelism); their offsets carry over unchanged.

The reactive scheduler and the autoscaler (``AdaptiveScheduler``,
``AutoscalerPolicy``, ``ReactiveAutoscaler``) come with the distributed
runtime (ROADMAP Queue A item 8.4b); their names raise
``NotImplementedError`` naming it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.core import keygroups
from flink_tpu_torch.graph.stream_graph import ExecutionPlan
from flink_tpu_torch.state.redistribute import (redistribute_channel_state,
                                                snapshot_operator_class,
                                                split_keyed_snapshot)
from flink_tpu_torch.state_processor.savepoint import (
    _is_keyed, _merged_operator_snapshot)
from flink_tpu_torch.testing import chaos

#: what waits for a later slice, by the item of ROADMAP Queue A
LATER = "the reactive scheduler and the autoscaler come with the " \
        "distributed runtime (8.4b)"


def _later(*_args, **_kwargs):
    raise NotImplementedError(f"not in this slice of flink_tpu_torch: "
                              f"{LATER}")


class AdaptiveScheduler:
    """Reactive scheduler over the MiniCluster: waits for 8.4b."""

    __init__ = _later


class AutoscalerPolicy:
    """The autoscaler's scaling policy: waits for 8.4b."""

    __init__ = _later


class ReactiveAutoscaler:
    """Backpressure-driven rescale under fire: waits for 8.4b."""

    __init__ = _later


def subtask_counts_of(plan) -> Tuple[Dict[str, int], Dict[int, list]]:
    """Subtask count per vertex (sources: one per split, like the
    MiniCluster; runtime-enumerated sources: a fixed reader count, splits
    assigned over the control plane) and the static split lists (the
    deploy side's function, ``flink_tpu/cluster/distributed.py``)."""
    counts: Dict[str, int] = {}
    splits_by_vertex: Dict[int, list] = {}
    for v in plan.vertices:
        if v.is_source:
            src = v.chain[0].source
            if getattr(src, "create_enumerator", None) is not None:
                splits_by_vertex[v.id] = None  # dynamic: request at runtime
                counts[v.uid] = v.parallelism
                continue
            splits = src.create_splits(v.parallelism)
            splits_by_vertex[v.id] = splits
            counts[v.uid] = max(1, len(splits))
        else:
            counts[v.uid] = v.parallelism
    return counts, splits_by_vertex


class SchedulerStates:
    CREATED = "Created"
    WAITING_FOR_RESOURCES = "WaitingForResources"
    EXECUTING = "Executing"
    RESTARTING = "Restarting"
    FINISHED = "Finished"
    FAILED = "Failed"
    CANCELED = "Canceled"


def _split_member(member: Dict[str, Any], max_parallelism: int,
                  n: int) -> List[Dict[str, Any]]:
    # operators with their own rescale split/merge pair (window aggregate,
    # session windows, CEP per-key state, two-phase-commit sinks) dispatch
    # through the ONE kind table the savepoint merge also uses
    cls = snapshot_operator_class(member)
    if cls is not None:
        return cls.split_snapshot(member, max_parallelism, n)
    if _is_keyed(member):
        fields = sorted({k for k in member
                         if k.startswith("state.") or k == "leaves"})
        return split_keyed_snapshot(member, fields, max_parallelism, n)
    # stateless / non-keyed member: subtask 0 keeps it, others start fresh
    return [member] + [{} for _ in range(n - 1)]


def _is_collect_sink_member(m: Any) -> bool:
    return isinstance(m, dict) and set(m) == {"batches"} \
        and isinstance(m["batches"], list)


def _union_shared_sink_members(ops: List[Dict[str, Any]], key_column: str,
                               max_parallelism: int) -> None:
    """Exactly-once merge for SHARED collect-sink chain members, in place.

    One CollectSink instance is shared by every subtask, so each
    subtask's snapshot is the shared row list AS OF ITS OWN barrier —
    under an unaligned cut those moments differ, and keeping any single
    copy is inconsistent: a row fired by subtask i between copy j's
    snapshot and i's own is present in i's copy and EVICTED from i's
    pane state, so dropping i's copy loses it forever.  The consistent
    composition is per-key owner filtering: subtask i's copy contributes
    exactly the rows of keys i OWNS (i's own fires run on i's thread, so
    they are in i's copy iff they preceded i's snapshot iff their pane
    state is gone) — union those slices and park the result on subtask
    0's member (the non-keyed merge keeps subtask 0), emptying the rest.
    Members without the key column fall back untouched."""
    P = len(ops)
    member_keys = sorted(k for k in ops[0]
                         if k.startswith("op") and k[2:].isdigit()
                         and all(_is_collect_sink_member(o.get(k))
                                 for o in ops if isinstance(o, dict)))
    for mk in member_keys:
        if any(key_column not in cols for o in ops
               for cols, _ts in o[mk]["batches"]):
            continue                # unkeyed rows: keep old behavior
        kept = []
        for i, o in enumerate(ops):
            for cols, ts in o[mk]["batches"]:
                keys = np.asarray(cols[key_column])
                mine = keygroups.route_raw_keys(
                    keys, P, max_parallelism) == i
                if mine.any():
                    kept.append((
                        {c: np.asarray(v)[mine] for c, v in cols.items()},
                        None if ts is None else np.asarray(ts)[mine]))
        for i, o in enumerate(ops):
            o[mk] = {"batches": kept} if i == 0 else {}


def _channel_sections(old_subs: List[Any]) -> List[Any]:
    return [(sub or {}).get("channel_state") if isinstance(sub, dict)
            else None for sub in old_subs]


def _has_inflight(sections: List[Any]) -> bool:
    for cs in sections:
        els = cs.get("elements", []) if isinstance(cs, dict) else cs
        if els:
            return True
    return False


def rescale_snapshot(snapshot: Dict[str, Any], plan: ExecutionPlan,
                     new_counts: Dict[str, int]) -> Dict[str, Any]:
    """A MiniCluster checkpoint taken at one parallelism -> restorable at
    another (the StateAssignmentOperation analog), INCLUDING unaligned
    checkpoints: persisted in-flight channel state (v2 sections) is
    decoded per element and re-routed by the record's own key into the
    new key-group ranges (``redistribute_channel_state`` — the FLIP-76
    follow-on, ``reDistributeKeyedStates`` for in-flight data); non-keyed
    and broadcast in-flight elements replay on their downstream's subtask
    0.  Legacy v1 sections with non-empty elements still fail loudly
    (``ChannelStateRescaleError``) — they carry no routing metadata.

    Fires the ``rescale.redistribute`` chaos point once per genuine
    rescale, BEFORE any state is transformed: a schedule killing/stalling
    here lands inside the rescale window with the pre-rescale checkpoint
    still intact, so the lifecycle's re-trigger is idempotent."""
    out: Dict[str, Any] = {}
    by_uid = {v.uid: v for v in plan.vertices}
    rescaled = sorted(
        uid for uid, entry in snapshot.items()
        if not uid.startswith("__") and uid in by_uid
        and not by_uid[uid].is_source and new_counts.get(uid) is not None
        and isinstance(entry, dict)
        and len(entry.get("subtasks", [])) != new_counts[uid])
    if rescaled:
        # the chaos seam of the rescale window (KillDuringRescale prey)
        chaos.fire("rescale.redistribute", uids=rescaled)
    producers: Dict[str, List[str]] = {}
    for u in plan.vertices:
        for e in u.out_edges:
            producers.setdefault(plan.by_id[e.target_id].uid,
                                 []).append(u.uid)

    def upstream_changed(uid: str) -> bool:
        """Did this vertex's INPUT topology change — i.e. does any
        producer's subtask count differ from the snapshot's?  A vertex
        whose own count AND whose producers' counts are unchanged keeps
        its channel state positionally (physical indices stay valid)."""
        for pu in producers.get(uid, []):
            pe = snapshot.get(pu)
            n_old = (len(pe.get("subtasks", []))
                     if isinstance(pe, dict) else None)
            n_want = new_counts.get(pu)
            if n_old is not None and n_want is not None \
                    and n_old != n_want:
                return True
        return False

    for uid, entry in snapshot.items():
        if uid.startswith("__"):
            out[uid] = entry
            continue
        v = by_uid.get(uid)
        n_new = new_counts.get(uid)
        if v is None or n_new is None:
            out[uid] = entry
            continue
        old_subs = entry.get("subtasks", []) if isinstance(entry, dict) else []
        if v.is_source:
            if len(old_subs) != n_new:
                raise ValueError(
                    f"rescale: source {uid!r} split count changed "
                    f"({len(old_subs)} -> {n_new}); adaptive rescale needs "
                    f"stable-split sources (files / log partitions)")
            out[uid] = entry
            continue
        sections = _channel_sections(old_subs)
        if len(old_subs) == n_new:
            if rescaled and _has_inflight(sections) \
                    and upstream_changed(uid):
                # the vertex keeps its parallelism but its UPSTREAM
                # rescales: physical channel indices die with the old
                # input topology — re-route its in-flight elements too
                # (keyed elements land back on the same subtask: the
                # key-group assignment is the same function).  A vertex
                # whose inputs are untouched keeps positional replay.
                new_secs = redistribute_channel_state(sections, n_new)
                entry = dict(entry)
                entry["subtasks"] = [
                    dict(sub or {}, channel_state=new_secs[i])
                    for i, sub in enumerate(entry["subtasks"])]
            out[uid] = entry
            continue
        new_secs = (redistribute_channel_state(sections, n_new)
                    if _has_inflight(sections) else None)
        # shared collect-sink members: per-key owner-filtered union BEFORE
        # the merge (keep-subtask-0 would drop rows other owners already
        # evicted from their pane state — see _union_shared_sink_members)
        kc = kmaxp = None
        for u in plan.vertices:
            for e in u.out_edges:
                if plan.by_id[e.target_id].uid == uid \
                        and e.partitioning == "hash" and e.key_column:
                    kc, kmaxp = e.key_column, u.max_parallelism
        if kc is not None and old_subs \
                and all(isinstance(s, dict) and isinstance(
                    s.get("operator"), dict) for s in old_subs):
            ops = [dict(s["operator"]) for s in old_subs]
            _union_shared_sink_members(ops, kc, kmaxp)
            entry = dict(entry)
            entry["subtasks"] = [dict(s, operator=o)
                                 for s, o in zip(old_subs, ops)]
        # strict: a keyed member that cannot merge must FAIL the rescale
        # (the lifecycle retries / rolls back), never silently redeploy
        # with only subtask 0's share of the state
        merged = _merged_operator_snapshot(entry, strict=True)
        inner = merged.get("operator", merged)
        maxp = v.max_parallelism
        member_keys = [k for k in inner
                       if k.startswith("op") and k[2:].isdigit()]
        parts: List[Dict[str, Any]]
        if member_keys:
            split_members = {mk: _split_member(inner[mk], maxp, n_new)
                             for mk in member_keys}
            passthrough = {k: v2 for k, v2 in inner.items()
                           if k not in member_keys}
            parts = [dict(passthrough,
                          **{mk: split_members[mk][i] for mk in member_keys})
                     for i in range(n_new)]
        else:
            parts = _split_member(inner, maxp, n_new)
        wrapped = []
        for p in parts:
            if isinstance(merged, dict) and "operator" in merged:
                w = {k: v2 for k, v2 in merged.items() if k != "operator"}
                w["operator"] = p
                wrapped.append(w)
            else:
                wrapped.append({"operator": p, "valve": None}
                               if "operator" not in p else p)
        # subtask snapshots are {"operator": ..., "valve": ...} shaped
        subs = [w if "operator" in w else {"operator": w} for w in wrapped]
        if new_secs is not None:
            for i, sub in enumerate(subs):
                sub["channel_state"] = new_secs[i]
        out[uid] = {"subtasks": subs}
    return out


def counts_for_plan(plan: ExecutionPlan) -> Dict[str, int]:
    """Per-vertex subtask count the deploying cluster will use — THE
    deploy-side implementation (``distributed.subtask_counts_of``), not a
    mirror of it: a rescale split to any other count would restore whole
    key-group ranges into subtasks that never deploy."""
    return subtask_counts_of(plan)[0]


def maybe_rescale_restore(restore: Optional[Dict[str, Any]],
                          plan: ExecutionPlan) -> Optional[Dict[str, Any]]:
    """Restore-time guard shared by MiniCluster / ProcessCluster deploys:
    when a snapshot's recorded subtask counts differ from what ``plan``
    will deploy, redistribute it (keyed state AND persisted in-flight
    channel state) through :func:`rescale_snapshot` instead of restoring
    positionally — a positional restore at the wrong parallelism silently
    drops/misroutes whole key-group ranges.  Snapshots matching the plan
    (and non-subtask layouts) pass through untouched."""
    if not isinstance(restore, dict):
        return restore
    counts = None
    mismatch = False
    for v in plan.vertices:
        entry = restore.get(v.uid)
        if not isinstance(entry, dict) or "subtasks" not in entry:
            continue
        if counts is None:
            counts = counts_for_plan(plan)
        if len(entry["subtasks"]) != counts[v.uid]:
            mismatch = True
            break
    if not mismatch:
        return restore
    return rescale_snapshot(restore, plan, counts)

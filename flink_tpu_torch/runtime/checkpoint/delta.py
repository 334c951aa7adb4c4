"""Increment (delta) checkpoint nodes: schema, detection, resolution.

Analog of the reference's incremental checkpoint handles
(``IncrementalRemoteKeyedStateHandle``) + the FLIP-158 changelog handle
(``ChangelogStateBackendHandle``): an operator that tracked its own
mutations since the last *confirmed* checkpoint snapshots a small
self-describing **increment dict** instead of its full dense state.  A
restore resolves ``base + ordered increment replay`` back to the exact
full-snapshot tree — bit-identical, so everything downstream of restore
(redistribute/rescale, SavepointWriter, queryable replicas) keeps
consuming the dense gid-indexed interchange unchanged.

Increment nodes carry ABSOLUTE values (last-writer-wins): each dirty
cell/row ships its current contents, so replaying an increment that
covers a superset of the exact delta (operators ship the union of all
unconfirmed dirt — crash consistency) is harmless.

Two increment kinds:

``window_delta``
    WindowAggOperator pane-granular delta: dirty ``(gid, pane)`` cell
    rows + the append-only key-index tail + changed count/value
    baselines, against the dense ``{counts [n,m], leaves [n,m,...]}``
    layout.
``changelog``
    ChangelogKeyedStateBackend mutation-log suffix beyond the confirmed
    log position (same materialization epoch), plus overwritten extras
    (timers).

The port's copy of ``flink_tpu/runtime/checkpoint/delta.py`` (host Python, as JAX's).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

#: marker key: a dict carrying it is an increment node, not full state
INCREMENT_KEY = "__increment__"


class IncrementChainError(RuntimeError):
    """An increment node has no base to apply against (broken chain)."""


def is_increment(node: Any) -> bool:
    return isinstance(node, dict) and node.get(INCREMENT_KEY) is not None


def tree_has_increment(tree: Any) -> bool:
    """True if any node anywhere in the snapshot tree is an increment."""
    if isinstance(tree, dict):
        if tree.get(INCREMENT_KEY) is not None:
            return True
        return any(tree_has_increment(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(tree_has_increment(v) for v in tree)
    return False


# --------------------------------------------------------------- resolution
def apply_increments(prev: Any, raw: Any) -> Any:
    """Resolve one raw checkpoint tree against the previous RESOLVED tree.

    Structural walk: increment nodes apply onto the node at the same path
    in ``prev`` (chains' ``op{i}`` nesting and subtask lists included);
    full nodes/leaves are taken from ``raw`` verbatim.  Returns a fully
    resolved tree; never mutates ``prev`` (appliers copy what they touch).
    """
    if is_increment(raw):
        kind = raw.get("kind")
        if kind == "window_delta":
            return apply_window_delta(prev, raw)
        if kind == "changelog":
            return apply_changelog(prev, raw)
        raise IncrementChainError(f"unknown increment kind {kind!r}")
    if isinstance(raw, dict):
        if not tree_has_increment(raw):
            return raw
        pd = prev if isinstance(prev, dict) else {}
        return {k: apply_increments(pd.get(k), v) for k, v in raw.items()}
    if isinstance(raw, (list, tuple)):
        if not tree_has_increment(raw):
            return raw
        pl = prev if isinstance(prev, (list, tuple)) else []
        out = [apply_increments(pl[i] if i < len(pl) else None, v)
               for i, v in enumerate(raw)]
        return tuple(out) if isinstance(raw, tuple) else out
    return raw


def resolve_chain(raws: List[Any]) -> Any:
    """Resolve an ordered chain ``[full base, inc_1, ..., inc_k]`` (ascending
    checkpoint order; the first element must be increment-free)."""
    if not raws:
        raise IncrementChainError("empty increment chain")
    if tree_has_increment(raws[0]):
        raise IncrementChainError(
            "increment chain does not start at a full base")
    resolved = raws[0]
    for raw in raws[1:]:
        resolved = apply_increments(resolved, raw)
    return resolved


# --------------------------------------------------------- window_delta apply
def _concat_reverse(prev_reverse: np.ndarray, tail: np.ndarray,
                    base_n: int, n: int) -> np.ndarray:
    prev_reverse = np.asarray(prev_reverse)
    if prev_reverse.shape[0] < base_n:
        raise IncrementChainError(
            f"key-index base too short: prev has {prev_reverse.shape[0]} "
            f"keys, increment expects >= {base_n}")
    tail = np.asarray(tail)
    if tail.shape[0] == 0:
        # avoid np.concatenate dtype promotion against an empty default-
        # dtype array (would corrupt int/object key arrays)
        out = prev_reverse[:base_n].copy()
    else:
        out = np.concatenate([prev_reverse[:base_n], tail])
    if out.shape[0] != n:
        raise IncrementChainError(
            f"key-index tail mismatch: resolved {out.shape[0]} keys, "
            f"increment says {n}")
    return out


def apply_window_delta(prev: Optional[Dict[str, Any]],
                       inc: Dict[str, Any]) -> Dict[str, Any]:
    """base + one WindowAggOperator pane-granular delta -> dense snapshot.

    The base may be a mesh per-shard-slice snapshot (increments bypass
    shard slicing); it is densified first so the result is always the
    dense gid-indexed interchange format.
    """
    if prev is None:
        raise IncrementChainError("window_delta increment without a base")
    from flink_tpu_torch.state.shard_layout import densify_keyed_snapshot
    prev = densify_keyed_snapshot(prev)

    meta = inc["meta"]
    n = int(inc["n"])
    base_n = int(inc["base_n"])
    snap: Dict[str, Any] = dict(meta)   # pane_base/max_pane/... absolutes

    # -- key index: append-only reverse array + shipped tail
    if inc.get("key_tail") is not None or "key_index" in prev:
        tail = inc.get("key_tail")
        if tail is None:
            tail = np.asarray([])[:0]
        prev_rev = prev.get("key_index", {}).get(
            "reverse", np.asarray(tail)[:0])
        snap["key_index"] = {
            "reverse": _concat_reverse(prev_rev, tail, base_n, n)}
        snap["key_index_kind"] = inc["key_index_kind"]

    pane_base = meta["pane_base"]
    max_pane = meta["max_pane"]
    leaf_meta = inc["leaf_meta"]   # [(init ndarray, dtype str, trailing shape)]
    has_grid = inc.get("has_grid",
                       pane_base is not None and (n > 0 or inc["cells"]))
    if has_grid:
        panes = np.arange(pane_base, max_pane + 1, dtype=np.int64)
        m = panes.size
        counts = np.zeros((n, m), np.int32)
        leaves = []
        for init, dtype, trailing in leaf_meta:
            fill = np.broadcast_to(
                np.asarray(init, np.dtype(dtype)),
                (n, m) + tuple(trailing)).copy()
            leaves.append(fill)
        # copy the intersecting base columns (rows [0:base rows])
        prev_panes = np.asarray(prev.get("panes", np.asarray([], np.int64)),
                                np.int64)
        prev_counts = prev.get("counts")
        if prev_counts is not None and prev_panes.size:
            rows = min(int(prev_counts.shape[0]), n)
            prev_col = {int(p): j for j, p in enumerate(prev_panes.tolist())}
            prev_leaves = prev.get("leaves", [])
            for j, p in enumerate(panes.tolist()):
                pj = prev_col.get(int(p))
                if pj is None:
                    continue
                counts[:rows, j] = np.asarray(prev_counts)[:rows, pj]
                for dst, src in zip(leaves, prev_leaves):
                    dst[:rows, j] = np.asarray(src)[:rows, pj]
        # scatter the dirty cell rows (absolute values)
        col = {int(p): j for j, p in enumerate(panes.tolist())}
        for cell in inc["cells"]:
            j = col.get(int(cell["pane"]))
            if j is None:
                continue        # pane expired between marking and the cut
            gids = np.asarray(cell["gids"], np.int64)
            counts[gids, j] = cell["counts"]
            for dst, src in zip(leaves, cell["leaves"]):
                dst[gids, j] = src
        snap["panes"] = panes
        snap["counts"] = counts
        snap["leaves"] = leaves
        snap["leaf_schema"] = inc["leaf_schema"]
    if inc.get("paging_stats") is not None:
        snap["paging_stats"] = inc["paging_stats"]

    # -- count/value baselines: drop-then-set, unchanged carried from base
    cb = {w: np.asarray(b).copy()
          for w, b in prev.get("count_baselines", {}).items()}
    for w in inc.get("cb_drops", ()):
        cb.pop(w, None)
    cb.update(inc.get("count_baselines", {}))
    # pad carried-over baselines to n: the full-snapshot format pads them
    # to the key count, and restore digests must match it exactly
    for w, b in list(cb.items()):
        if b.shape[0] < n:
            grown = np.zeros(n, b.dtype)
            grown[:b.shape[0]] = b
            cb[w] = grown
        elif b.shape[0] > n:
            cb[w] = b[:n].copy()
    if cb:
        snap["count_baselines"] = cb
    vb = {w: [np.asarray(l).copy() for l in ls]
          for w, ls in prev.get("value_baselines", {}).items()}
    for w in inc.get("vb_drops", ()):
        vb.pop(w, None)
    vb.update(inc.get("value_baselines", {}))
    if vb:
        snap["value_baselines"] = vb
    return snap


# ----------------------------------------------------------- changelog apply
def apply_changelog(prev: Optional[Dict[str, Any]],
                    inc: Dict[str, Any]) -> Dict[str, Any]:
    """base + one changelog-suffix increment -> full backend snapshot.

    The previous resolved node holds the full mutation log up to its cut;
    the increment ships only the suffix beyond the confirmed position
    (same materialization epoch), so ``prev_log[:log_base] + suffix`` is
    exactly the backend's current log."""
    if prev is None:
        raise IncrementChainError("changelog increment without a base")
    log_base = int(inc["log_base"])
    prev_log = list(prev.get("changelog", []))
    if len(prev_log) < log_base:
        raise IncrementChainError(
            f"changelog base too short: prev has {len(prev_log)} entries, "
            f"increment resumes at {log_base}")
    snap = {k: v for k, v in prev.items()}
    snap["changelog"] = prev_log[:log_base] + list(inc["log_suffix"])
    snap["changelog_backend"] = True
    for k, v in inc.get("extras", {}).items():
        snap[k] = v
    return snap


# ------------------------------------------------------------------ sizing
def state_size(tree: Any) -> int:
    """Approximate byte size of a snapshot tree (array leaves dominate)."""
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    if isinstance(tree, dict):
        return sum(state_size(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(state_size(v) for v in tree)
    if isinstance(tree, (bytes, bytearray, str)):
        return len(tree)
    return 8

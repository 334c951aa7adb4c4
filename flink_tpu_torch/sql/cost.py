"""Cost-based join reordering — the Selinger-style optimizer stage.

The rewrite pipeline (``rules.py``) was rule-based only; this module adds
the reference's cost-based dimension (``flink-optimizer/src/main/java/org/
apache/flink/optimizer/Optimizer.java:67`` with ``compile:402``; Blink side
``PlannerBase.scala:82``), scoped to the decision with the highest payoff:
**inner-equi-join order**.

- **Statistics**: row counts + per-column NDV captured at registration for
  in-memory tables (``TableStats``); sources without stats keep syntactic
  order (the reference behaves the same without catalog statistics).
- **Cardinality model**: filtered base cardinalities (classic selectivity
  heuristics: equality 1/NDV, range 0.3, default 0.25, conjunct product)
  and equi-join selectivity ``1 / max(ndv_left, ndv_right)``.
- **Search**: dynamic programming over CONNECTED subsets of the join graph
  (left-deep, matching the executor's chained hash joins), minimizing the
  sum of intermediate cardinalities.  n is small (<= 8 relations) so the
  2^n DP is exact — the ``GreedyJoinOrder`` fallback of textbooks isn't
  needed.
- **EXPLAIN**: the chosen order and its estimated cost (vs the syntactic
  plan's) surface through ``EXPLAIN``'s rewrite section.

Only inner joins with single-edge equi conditions over a tree-shaped join
graph reorder; anything else (outer joins, cyclic/multi-edge conditions,
missing stats) keeps the written order.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from itertools import combinations
from typing import Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.sql.parser import (Binary, Column, Expr, JoinClause,
                                        SelectStmt)

#: reorder cap: 2^n DP states; beyond this keep syntactic order
MAX_RELATIONS = 8


@dataclass
class TableStats:
    """Catalog statistics (``CatalogTableStatistics`` analog)."""

    row_count: int
    ndv: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def from_columns(cls, data: Dict[str, np.ndarray]) -> "TableStats":
        n = 0
        ndv: Dict[str, int] = {}
        for name, arr in data.items():
            a = np.asarray(arr)
            n = max(n, a.shape[0])
            try:
                ndv[name] = int(len(np.unique(a)))
            except TypeError:
                ndv[name] = max(a.shape[0], 1)
        return cls(row_count=n, ndv=ndv)


def _conjuncts(e: Optional[Expr]) -> List[Expr]:
    if e is None:
        return []
    from flink_tpu_torch.sql.rules import _conjuncts as _rule_conjuncts
    return _rule_conjuncts(e)


def filter_selectivity(pred: Optional[Expr], stats: TableStats) -> float:
    """Classic System-R heuristics, conjuncts multiplied."""
    sel = 1.0
    for c in _conjuncts(pred):
        if isinstance(c, Binary) and c.op == "=":
            col = c.left if isinstance(c.left, Column) else (
                c.right if isinstance(c.right, Column) else None)
            nd = stats.ndv.get(col.name) if col is not None else None
            sel *= 1.0 / nd if nd else 0.1
        elif isinstance(c, Binary) and c.op in ("<", ">", "<=", ">="):
            sel *= 0.3
        else:
            sel *= 0.25
    return max(sel, 1e-9)


@dataclass
class _Rel:
    idx: int
    table: str
    alias: str
    pre_filter: Optional[Expr]
    rows: float                      # post-filter estimate
    ndv: Dict[str, int]


@dataclass
class _Edge:
    a: int
    b: int
    col_a: str
    col_b: str
    on: Expr

    def other(self, i: int) -> int:
        return self.b if i == self.a else self.a

    def selectivity(self, rels: List[_Rel]) -> float:
        nd = max(rels[self.a].ndv.get(self.col_a, 0),
                 rels[self.b].ndv.get(self.col_b, 0), 1)
        return 1.0 / nd


def _resolve(col: Column, rels: List[_Rel]) -> Optional[Tuple[int, str]]:
    if col.table is not None:
        for r in rels:
            if r.alias == col.table:
                return (r.idx, col.name) if col.name in r.ndv else None
        return None
    owners = [r.idx for r in rels if col.name in r.ndv]
    return (owners[0], col.name) if len(owners) == 1 else None


def _cardinality(subset: frozenset, rels: List[_Rel],
                 edges: List[_Edge]) -> float:
    card = 1.0
    for i in subset:
        card *= max(rels[i].rows, 1.0)
    for e in edges:
        if e.a in subset and e.b in subset:
            card *= e.selectivity(rels)
    return card


def _order_cost(order: List[int], rels: List[_Rel],
                edges: List[_Edge]) -> float:
    """Sum of intermediate (and final) join output cardinalities —
    the left-deep pipeline's materialization cost."""
    cost = 0.0
    s: set = {order[0]}
    for t in order[1:]:
        s.add(t)
        cost += _cardinality(frozenset(s), rels, edges)
    return cost


def _best_order(rels: List[_Rel],
                edges: List[_Edge]) -> Tuple[List[int], float]:
    """Exact DP over connected subsets; left-deep orders."""
    n = len(rels)
    neighbors: Dict[int, set] = {i: set() for i in range(n)}
    for e in edges:
        neighbors[e.a].add(e.b)
        neighbors[e.b].add(e.a)
    best: Dict[frozenset, Tuple[float, List[int]]] = {
        frozenset([i]): (0.0, [i]) for i in range(n)}
    for size in range(2, n + 1):
        for subset in combinations(range(n), size):
            s = frozenset(subset)
            card_s = None
            entry = None
            for t in subset:
                rest = s - {t}
                prev = best.get(rest)
                if prev is None or not (neighbors[t] & rest):
                    continue
                if card_s is None:
                    card_s = _cardinality(s, rels, edges)
                cost = prev[0] + card_s
                if entry is None or cost < entry[0]:
                    entry = (cost, prev[1] + [t])
            if entry is not None:
                best[s] = entry
    full = best.get(frozenset(range(n)))
    if full is None:                       # disconnected join graph
        return list(range(n)), float("inf")
    return full[1], full[0]


def join_reorder(stmt: SelectStmt, catalog) -> Optional[SelectStmt]:
    """Rewrite rule: pick the cheapest left-deep inner-join order by the
    cost model above.  Returns None (no change) when inapplicable."""
    if not isinstance(stmt, SelectStmt):
        return None                        # UNION branches rewrite per leg
    if getattr(stmt, "join_order_cost", None) is not None:
        return None                        # already decided this query
    joins = stmt.joins
    if len(joins) < 2 or len(joins) + 1 > MAX_RELATIONS:
        return None
    if any(j.kind != "inner" for j in joins):
        return None                        # outer joins pin their order
    from flink_tpu_torch.sql.parser import Star
    if any(isinstance(it.expr, Star) for it in stmt.items):
        return None    # SELECT * exposes post-join column ORDER — the
        #                schema must not depend on the optimizer's choice
    # relations with stats
    rels: List[_Rel] = []
    names = [(stmt.table, stmt.table_alias, stmt.scan_filter)] + [
        (j.table, j.alias, j.pre_filter) for j in joins]
    for i, (tbl, alias, pre) in enumerate(names):
        if not isinstance(tbl, str):
            return None                    # derived-table base: keep order
        ct = catalog.get(tbl) if hasattr(catalog, "get") else None
        get_stats = getattr(ct, "get_stats", None) if ct is not None else None
        stats = get_stats() if get_stats is not None else None
        if stats is None:
            return None                    # no stats: keep syntactic order
        rows = stats.row_count * filter_selectivity(pre, stats)
        rels.append(_Rel(i, tbl, alias or tbl, pre, rows, stats.ndv))
    # edges from the ON conditions (single equi edge each)
    edges: List[_Edge] = []
    for j in joins:
        on = j.on
        if not (isinstance(on, Binary) and on.op == "="
                and isinstance(on.left, Column)
                and isinstance(on.right, Column)):
            return None
        a = _resolve(on.left, rels)
        b = _resolve(on.right, rels)
        if a is None or b is None or a[0] == b[0]:
            return None
        edges.append(_Edge(a[0], b[0], a[1], b[1], on))
    # tree check: n edges over n+1 nodes must be acyclic/connected for the
    # one-edge-per-join rebuild below to hold
    seen: set = set()
    parent = list(range(len(rels)))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for e in edges:
        ra, rb = find(e.a), find(e.b)
        if ra == rb:
            return None                    # cyclic condition graph
        parent[ra] = rb
    seen = {find(i) for i in range(len(rels))}
    if len(seen) != 1:
        return None                        # disconnected (cross join)

    order, cost = _best_order(rels, edges)
    syntactic = list(range(len(rels)))
    syn_cost = _order_cost(syntactic, rels, edges)
    note = (f"order={[rels[i].alias for i in order]} est_cost={cost:.0f} "
            f"(syntactic={syn_cost:.0f})")
    if order == syntactic:
        return replace(stmt, join_order_cost=note)
    # rebuild: new base + joins, each carrying the edge that connects it
    by_edge: Dict[int, List[_Edge]] = {}
    for e in edges:
        by_edge.setdefault(e.a, []).append(e)
        by_edge.setdefault(e.b, []).append(e)
    placed = {order[0]}
    new_joins: List[JoinClause] = []
    for t in order[1:]:
        connecting = [e for e in by_edge.get(t, ())
                      if e.other(t) in placed]
        if len(connecting) != 1:           # tree property guarantees 1
            return None
        r = rels[t]
        new_joins.append(JoinClause(
            table=r.table,
            alias=names[t][1],
            kind="inner", on=connecting[0].on, pre_filter=r.pre_filter))
        placed.add(t)
    base = rels[order[0]]
    return replace(stmt, table=base.table, table_alias=names[order[0]][1],
                   scan_filter=base.pre_filter, joins=new_joins,
                   join_order_cost=note)

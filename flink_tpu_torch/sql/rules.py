"""Logical rewrite stage: rule pipeline between parse and lowering.

The reference's Blink planner optimizes the logical plan with Calcite rule
sets + a cost model before producing physical nodes
(``PlannerBase.scala:155``, rules in
``flink-table-planner-blink/src/main/scala/.../plan/rules/``).  This module
is the analog for the direct-lowering planner: AST→AST rewrite rules applied
to a fixpoint, each recording its application so ``EXPLAIN`` can show the
optimized shape (VERDICT r2 missing #1).

Rules:
- ``union_associativity``   — mixed ``UNION``/``UNION ALL`` chains nest
  left-associatively into homogeneous unions (closes the mixed-chain gap).
- ``over_partition_split``  — a SELECT whose OVER windows use SEVERAL
  (PARTITION BY, ORDER BY) groups splits into nested SELECTs, one group per
  level (closes the multiple-OVER-partitionings gap).
- ``filter_pushdown``       — WHERE conjuncts referencing a single join
  input move to that input's pre-join filter; outer-query conjuncts over a
  derived table's pass-through columns push into the subquery.
- ``projection_prune``      — a derived table's SELECT list prunes to the
  columns the outer query references; base-table scans record the referenced
  column set so lowering projects early (``scan_columns``).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, Dict, List, Optional, Set, Tuple

from flink_tpu_torch.sql.parser import (AGG_FUNCS, WINDOW_AUX, WINDOW_FUNCS,
                                        Binary, Call, Column, Expr, OverCall,
                                        SelectItem, SelectStmt, Star,
                                        UnionStmt)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _children(expr: Expr) -> List[Expr]:
    from flink_tpu_torch.sql.parser import (Between, Case, Cast, InList,
                                            IsNull, Like, Unary)
    if isinstance(expr, Unary):
        return [expr.operand]
    if isinstance(expr, Binary):
        return [expr.left, expr.right]
    if isinstance(expr, Call):
        return list(expr.args)
    if isinstance(expr, OverCall):
        out = list(expr.args)
        if expr.partition_by is not None:
            out.append(expr.partition_by)
        if expr.order_by is not None:
            out.append(expr.order_by)
        return out
    if isinstance(expr, Cast):
        return [expr.expr]
    if isinstance(expr, Case):
        out = [x for pair in expr.whens for x in pair]
        if expr.default is not None:
            out.append(expr.default)
        return out
    if isinstance(expr, Between):
        return [expr.expr, expr.lo, expr.hi]
    if isinstance(expr, InList):
        return [expr.expr] + list(expr.items)
    if isinstance(expr, IsNull):
        return [expr.expr]
    if isinstance(expr, Like):
        return [expr.expr]
    return []


def _columns_of(expr: Optional[Expr]) -> List[Column]:
    if expr is None:
        return []
    if isinstance(expr, Column):
        return [expr]
    out: List[Column] = []
    for c in _children(expr):
        out.extend(_columns_of(c))
    return out


def _contains_agg_or_over(expr: Expr) -> bool:
    if isinstance(expr, OverCall):
        return True
    if isinstance(expr, Call) and expr.name in AGG_FUNCS:
        return True
    return any(_contains_agg_or_over(c) for c in _children(expr))


def _strip_qualifiers(expr: Expr) -> Expr:
    from flink_tpu_torch.sql.planner import _transform
    return _transform(expr, lambda e: Column(e.name)
                      if isinstance(e, Column) and e.table is not None
                      else None)


def _conjuncts(expr: Expr) -> List[Expr]:
    if isinstance(expr, Binary) and expr.op.upper() == "AND":
        return _conjuncts(expr.left) + _conjuncts(expr.right)
    return [expr]


def _and_all(parts: List[Expr]) -> Optional[Expr]:
    if not parts:
        return None
    out = parts[0]
    for p in parts[1:]:
        out = Binary("AND", out, p)
    return out


def _referenced_names(stmt: SelectStmt) -> Optional[Set[str]]:
    """Unqualified column names the stmt references anywhere; None = all
    (a Star appears)."""
    names: Set[str] = set()
    exprs: List[Optional[Expr]] = [it.expr for it in stmt.items]
    exprs += [stmt.where, stmt.having]
    exprs += list(stmt.group_by)
    exprs += [e for e, _ in stmt.order_by]
    exprs += [j.on for j in stmt.joins]
    for e in exprs:
        if e is None:
            continue
        if isinstance(e, Star) or any(isinstance(c, Star)
                                      for c in _children(e)):
            return None
        for c in _columns_of(e):
            names.add(c.name)
    if any(isinstance(it.expr, Star) for it in stmt.items):
        return None
    return names


def _over_group(oc: OverCall):
    return (repr(oc.partition_by), repr(oc.order_by), oc.ascending)


def _collect_overs(expr: Expr, out: List[OverCall]) -> None:
    if isinstance(expr, OverCall):
        out.append(expr)
        return                      # OVER calls do not nest
    for c in _children(expr):
        _collect_overs(c, out)


def _replace_exprs(expr: Expr, mapping: Dict[Expr, Expr]) -> Expr:
    from flink_tpu_torch.sql.planner import _transform
    return _transform(expr, lambda e: mapping.get(e))


# ---------------------------------------------------------------------------
# rules — each returns a rewritten stmt or None (no change)
# ---------------------------------------------------------------------------

def union_associativity(stmt, catalog) -> Optional[UnionStmt]:
    """``A UNION B UNION ALL C`` = ``(A UNION B) UNION ALL C`` (SQL
    left-associativity): restructure a MIXED flat chain into nested
    homogeneous unions the lowering already handles."""
    if not isinstance(stmt, UnionStmt) or len(set(stmt.alls)) <= 1:
        return None
    cur = stmt.parts[0]
    run = [cur]
    run_all = stmt.alls[0]

    def close(parts, is_all):
        if len(parts) == 1:
            return parts[0]
        return UnionStmt(parts=list(parts), alls=[is_all] * (len(parts) - 1),
                         order_by=[], limit=None)

    for part, is_all in zip(stmt.parts[1:], stmt.alls):
        if is_all == run_all:
            run.append(part)
        else:
            run = [close(run, run_all), part]
            run_all = is_all
    top = close(run, run_all)
    if isinstance(top, UnionStmt):
        top.order_by = stmt.order_by
        top.limit = stmt.limit
        return top
    # degenerate (single part): wrap to carry order/limit
    return UnionStmt(parts=[top], alls=[], order_by=stmt.order_by,
                     limit=stmt.limit)


def over_partition_split(stmt, catalog) -> Optional[SelectStmt]:
    """Multiple distinct (PARTITION BY, ORDER BY) OVER groups in one SELECT
    split into nested SELECTs: the innermost computes one group's aggregates
    as appended columns, the outer consumes them — repeat until one group
    per level (``StreamExecOverAggregate`` handles one ordering each)."""
    if not isinstance(stmt, SelectStmt) or stmt.group_by:
        return None
    overs: List[OverCall] = []
    for it in stmt.items:
        _collect_overs(it.expr, overs)
    groups: Dict[tuple, List[OverCall]] = {}
    for oc in overs:
        groups.setdefault(_over_group(oc), []).append(oc)
    if len(groups) <= 1:
        return None
    # innermost level computes the FIRST group; the (recursively rewritten)
    # outer level consumes its columns
    first_key = _over_group(overs[0])
    inner_items = [SelectItem(Star(), None)]
    mapping: Dict[Expr, Expr] = {}
    for i, oc in enumerate(groups[first_key]):
        name = f"__overg{i}"
        inner_items.append(SelectItem(oc, name))
        mapping[oc] = Column(name)
    inner = SelectStmt(items=inner_items, table=stmt.table,
                       table_alias=stmt.table_alias,
                       joins=stmt.joins, where=stmt.where)
    # the outer's FROM is an anonymous subquery: qualified references to
    # the original alias must become bare names (the subquery exposes
    # flat output columns)
    outer_items = [
        SelectItem(_strip_qualifiers(_replace_exprs(it.expr, mapping)),
                   it.alias)
        for it in stmt.items]
    outer_order = [(_strip_qualifiers(_replace_exprs(e, mapping)), asc)
                   for e, asc in stmt.order_by]
    return SelectStmt(items=outer_items, table=inner, table_alias=None,
                      joins=[], where=None, group_by=[],
                      having=stmt.having,   # preserved: lowering validates
                      order_by=outer_order, limit=stmt.limit)


def filter_pushdown(stmt, catalog) -> Optional[SelectStmt]:
    """WHERE conjuncts that reference exactly one join input move to that
    input's ``pre_filter`` (applied before the join); conjuncts over a
    derived table's pass-through output columns move into the subquery."""
    if not isinstance(stmt, SelectStmt) or stmt.where is None:
        return None
    # --- joins: per-input predicate extraction
    if stmt.joins and stmt.table in (catalog or {}):
        schemas: Dict[str, Set[str]] = {}
        base_alias = stmt.table_alias or stmt.table
        schemas[base_alias] = set(catalog[stmt.table].columns)
        # a WHERE predicate on a NULL-PRODUCING side of an outer join is
        # NOT equivalent pre-join (it would keep null-extended rows the
        # post-join filter removes): only non-null-producing inputs accept
        # pushdown — right inputs of INNER joins; the base/left chain when
        # no RIGHT/FULL join can null-extend it
        pushable_aliases: Set[str] = set()
        if all(j.kind in ("inner", "left") for j in stmt.joins):
            pushable_aliases.add(base_alias)
        for j in stmt.joins:
            if j.table in catalog:
                schemas[j.alias or j.table] = set(catalog[j.table].columns)
                if j.kind == "inner":
                    pushable_aliases.add(j.alias or j.table)
        remaining: List[Expr] = []
        pushed: Dict[str, List[Expr]] = {}
        for conj in _conjuncts(stmt.where):
            if _contains_agg_or_over(conj):
                remaining.append(conj)
                continue
            owners: Set[str] = set()
            ok = True
            for col in _columns_of(conj):
                if col.table is not None:
                    owners.add(col.table)
                else:
                    holders = [a for a, cols in schemas.items()
                               if col.name in cols]
                    if len(holders) == 1:
                        owners.add(holders[0])
                    else:
                        ok = False
                        break
            if ok and len(owners) == 1 and \
                    next(iter(owners)) in pushable_aliases:
                # the input stream pre-join carries BARE column names
                pushed.setdefault(owners.pop(), []).append(
                    _strip_qualifiers(conj))
            else:
                remaining.append(conj)
        if pushed:
            new_joins = []
            changed = False
            for j in stmt.joins:
                a = j.alias or j.table
                if a in pushed:
                    prior = [j.pre_filter] if j.pre_filter is not None else []
                    pre = _and_all(prior + pushed.pop(a))
                    new_joins.append(replace(j, pre_filter=pre))
                    changed = True
                else:
                    new_joins.append(j)
            base_pre = stmt.scan_filter
            if base_alias in pushed:
                base_pre = _and_all(
                    ([base_pre] if base_pre is not None else [])
                    + pushed.pop(base_alias))
                changed = True
            if changed:
                return replace(stmt, joins=new_joins,
                               where=_and_all(remaining),
                               scan_filter=base_pre)
        return None
    # --- derived table: push conjuncts over pass-through columns inside
    if isinstance(stmt.table, SelectStmt) and not stmt.joins:
        inner = stmt.table
        if inner.group_by or inner.having is not None or inner.limit \
                is not None or inner.order_by:
            return None
        if any(_contains_agg_or_over(it.expr) for it in inner.items):
            # filtering BELOW a window/aggregate computation changes its
            # input rows (running sums, ROW_NUMBER Top-N): not equivalent
            return None
        passthrough: Dict[str, Expr] = {}
        for it in inner.items:
            if isinstance(it.expr, Column) and it.expr.table is None:
                passthrough[it.alias or it.expr.name] = it.expr
        pushable: List[Expr] = []
        remaining = []
        for conj in _conjuncts(stmt.where):
            cols = _columns_of(conj)
            if (cols and not _contains_agg_or_over(conj)
                    and all(c.table is None and c.name in passthrough
                            for c in cols)):
                pushable.append(_replace_exprs(
                    conj, {Column(n): e for n, e in passthrough.items()}))
            else:
                remaining.append(conj)
        if not pushable:
            return None
        new_inner = replace(
            inner, where=_and_all(
                ([inner.where] if inner.where is not None else [])
                + pushable))
        return replace(stmt, table=new_inner, where=_and_all(remaining))
    return None


def projection_prune(stmt, catalog) -> Optional[SelectStmt]:
    """Prune a derived table's SELECT list to the outer query's referenced
    columns, and record the referenced column set on base-table scans so
    lowering projects before any operator (``scan_columns``)."""
    if not isinstance(stmt, SelectStmt):
        return None
    refs = _referenced_names(stmt)
    # --- derived table: prune inner items
    if isinstance(stmt.table, SelectStmt) and refs is not None:
        inner = stmt.table
        if not inner.order_by and not any(isinstance(it.expr, Star)
                                          for it in inner.items):
            from flink_tpu_torch.sql.expressions import expr_name
            named = [(it.alias or expr_name(it.expr, i), it)
                     for i, it in enumerate(inner.items)]
            # fixpoint: a kept item's own expression may reference sibling
            # outputs (e.g. ROW_NUMBER() OVER (ORDER BY amount) keeps the
            # 'amount' item — the Top-N lowering reads it from the subquery)
            needed = set(refs)
            while True:
                extra = {c.name for nm, it in named if nm in needed
                         for c in _columns_of(it.expr)}
                if extra <= needed:
                    break
                needed |= extra
            keep = [it for nm, it in named if nm in needed]
            if keep and len(keep) < len(inner.items):
                return replace(stmt, table=replace(inner, items=keep))
    # --- base table: record the scan projection
    if (isinstance(stmt.table, str) and stmt.table in (catalog or {})
            and not stmt.joins and refs is not None
            and stmt.scan_columns is None):
        cols = [c for c in catalog[stmt.table].columns if c in refs]
        rowtime = getattr(catalog[stmt.table], "rowtime", None)
        if rowtime and rowtime not in cols \
                and rowtime in catalog[stmt.table].columns:
            cols.append(rowtime)
        if cols and len(cols) < len(catalog[stmt.table].columns):
            return replace(stmt, scan_columns=tuple(cols))
    return None


def _join_reorder(stmt, catalog):
    # cost stage lives in sql/cost.py; runs AFTER filter_pushdown so the
    # selectivity model sees the pushed per-input predicates
    from flink_tpu_torch.sql.cost import join_reorder
    return join_reorder(stmt, catalog)


RULES: List[Tuple[str, Callable]] = [
    ("union_associativity", union_associativity),
    ("over_partition_split", over_partition_split),
    ("filter_pushdown", filter_pushdown),
    ("projection_prune", projection_prune),
    ("join_reorder(cost-based)", _join_reorder),
]


def apply_rules(stmt, catalog, applied: Optional[List[str]] = None,
                max_iters: int = 10):
    """Run the rule pipeline to a fixpoint (bounded).  ``applied`` collects
    rule names for EXPLAIN."""
    for _ in range(max_iters):
        changed = False
        for name, rule in RULES:
            new = rule(stmt, catalog)
            if new is not None:
                stmt = new
                changed = True
                if applied is not None:
                    applied.append(name)
        if not changed:
            break
    return stmt

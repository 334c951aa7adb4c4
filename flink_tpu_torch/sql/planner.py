"""SQL planner: SELECT AST → DataStream pipeline.

The reference's Blink planner lowers Calcite plans through optimization into
``ExecNode``s that build stream operators — the group-window path being
``StreamExecGroupWindowAggregate.java:103`` → ``WindowOperatorBuilder``
(``createWindowOperator:345``) with a code-generated aggregate handler.  Here
the lowering is direct: WHERE → vectorized filter, expression evaluation →
columnar closures (``expressions.py``, the codegen analog), GROUP BY
TUMBLE/HOP/SESSION → the paned ``WindowAggOperator`` / merging
``SessionWindowOperator`` with a ``TupleAggregator`` (one accumulator pytree
holding every aggregate — the ``NamespaceAggsHandleFunction`` analog), and a
final projection map.  Bounded non-windowed GROUP BY runs on ``GlobalWindows``
firing at end-of-input.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from flink_tpu_torch.core.functions import (AvgAggregator, CountAggregator,
                                            MaxAggregator, MinAggregator,
                                            SumAggregator, TupleAggregator)
from flink_tpu_torch.sql.expressions import (ExprCompiler, PlanError,
                                             expr_name, to_column)
from flink_tpu_torch.sql.parser import (AGG_FUNCS, WINDOW_AUX, WINDOW_FUNCS,
                                        Between, Binary, Call, Case, Cast,
                                        Column, Expr, InList, Interval, IsNull,
                                        Like, Literal, OverCall, SelectItem,
                                        SelectStmt, Star, Unary)
from flink_tpu_torch.windowing.assigners import (EventTimeSessionWindows,
                                                 GlobalWindows,
                                                 SlidingEventTimeWindows,
                                                 TumblingEventTimeWindows)


@dataclass
class AggSpec:
    """One aggregate call split out of the select/having expressions."""

    out_name: str       # "__agg0", ... — ACC entry + fired column name
    func: str           # SUM/COUNT/AVG/MIN/MAX
    arg: Optional[Expr]  # None for COUNT(*)
    distinct: bool = False


@dataclass
class WindowSpec:
    kind: str          # TUMBLE/HOP/SESSION
    time_col: str
    size_ms: int
    slide_ms: Optional[int] = None  # HOP only
    offset_ms: int = 0              # synthetic TUMBLE alignment (HOP dedup)


@dataclass
class QueryPlan:
    """Planned query: the output DataStream + result metadata."""

    stream: Any                       # DataStream producing the result rows
    output_columns: List[str]
    order_by: List[Tuple[str, bool]] = field(default_factory=list)
    limit: Optional[int] = None
    #: time-attribute propagation (the reference's rowtime column survives
    #: projections): output column carrying the rowtime, if any, and whether
    #: batch timestamps are already assigned in-stream — consumed when the
    #: plan feeds a derived table
    rowtime: Optional[str] = None
    timestamps_assigned: bool = False
    #: the result rows are a CHANGELOG (op column carries the change kind)
    #: — set by TableEnvironment._plan from the planner's per-plan flag;
    #: consumers must fold retractions, never sniff column names
    changelog: bool = False


def _transform(expr: Expr, fn: Callable[[Expr], Optional[Expr]]) -> Expr:
    """Generic top-down rewrite over frozen AST nodes: ``fn`` returns a
    replacement (whole-subtree matches win) or None to recurse."""
    hit = fn(expr)
    if hit is not None:
        return hit
    rec = lambda e: _transform(e, fn)  # noqa: E731
    if isinstance(expr, Unary):
        return Unary(expr.op, rec(expr.operand))
    if isinstance(expr, Binary):
        return Binary(expr.op, rec(expr.left), rec(expr.right))
    if isinstance(expr, Call):
        return Call(expr.name, tuple(rec(a) for a in expr.args), expr.distinct)
    if isinstance(expr, OverCall):
        return OverCall(
            expr.func,
            rec(expr.partition_by) if expr.partition_by is not None else None,
            rec(expr.order_by) if expr.order_by is not None else None,
            expr.ascending, tuple(rec(a) for a in expr.args),
            expr.frame_rows, expr.frame_range_ms, expr.frame_is_rows,
            expr.distinct)
    if isinstance(expr, Cast):
        return Cast(rec(expr.expr), expr.type_name)
    if isinstance(expr, Case):
        return Case(tuple((rec(c), rec(r)) for c, r in expr.whens),
                    rec(expr.default) if expr.default is not None else None)
    if isinstance(expr, Between):
        return Between(rec(expr.expr), rec(expr.lo), rec(expr.hi), expr.negated)
    if isinstance(expr, InList):
        return InList(rec(expr.expr), tuple(rec(i) for i in expr.items),
                      expr.negated)
    if isinstance(expr, Like):
        return Like(rec(expr.expr), expr.pattern, expr.negated)
    if isinstance(expr, IsNull):
        return IsNull(rec(expr.expr), expr.negated)
    return expr


def _walk_replace(expr: Expr, mapping: Dict[Expr, Expr]) -> Expr:
    """Structural find/replace (GROUP BY expressions → key columns), plus
    window auxiliary calls (``TUMBLE_START(...)`` etc.,
    ``StreamExecGroupWindowAggregate`` window-property resolution) → the
    ``window_start``/``window_end`` columns the window operators emit."""
    def fn(e: Expr) -> Optional[Expr]:
        if e in mapping:
            return mapping[e]
        if isinstance(e, Call) and e.name in WINDOW_AUX:
            if e.name.endswith("_START"):
                return Column("window_start")
            if e.name.endswith("_END"):
                return Column("window_end")
            # *_ROWTIME / *_PROCTIME = window.maxTimestamp = end - 1
            return Binary("-", Column("window_end"), Literal(1))
        return None
    return _transform(expr, fn)


def _rewrite_qualified(stmt: SelectStmt, qual_map,
                       ambiguous: Optional[set] = None) -> SelectStmt:
    """Resolve ``alias.col`` references to flat post-join column names and
    strip qualifiers (single-table queries validate the alias too).
    ``ambiguous``: bare names that exist on both join sides — referencing
    one unqualified is an error, not a silent left-side pick."""
    import copy as _copy

    amb = ambiguous or set()

    def fn(e: Expr) -> Optional[Expr]:
        if isinstance(e, Column) and e.table is not None:
            key = (e.table, e.name)
            if key not in qual_map:
                known = sorted({t for t, _ in qual_map})
                raise PlanError(f"{e.table}.{e.name}: unknown qualifier "
                                f"(tables in scope: {known})")
            return Column(qual_map[key])
        if isinstance(e, Column) and e.name in amb:
            raise PlanError(f"column {e.name!r} is ambiguous after JOIN — "
                            f"qualify it with a table alias")
        return None

    stmt = _copy.copy(stmt)
    stmt.items = [SelectItem(_transform(it.expr, fn), it.alias)
                  for it in stmt.items]
    if stmt.where is not None:
        stmt.where = _transform(stmt.where, fn)
    stmt.group_by = [_transform(g, fn) for g in stmt.group_by]
    if stmt.having is not None:
        stmt.having = _transform(stmt.having, fn)
    stmt.order_by = [(_transform(e, fn), asc) for e, asc in stmt.order_by]
    return stmt


def _extract_aggs(expr: Expr, specs: List[AggSpec],
                  cache: Dict[Expr, Column]) -> Expr:
    """Replace aggregate calls with placeholder columns, collecting specs
    (full node coverage via the generic ``_transform`` walker)."""
    def fn(e: Expr) -> Optional[Expr]:
        if isinstance(e, Call) and e.name in AGG_FUNCS:
            if e in cache:
                return cache[e]
            arg = None
            if not (len(e.args) == 1 and isinstance(e.args[0], Star)):
                if len(e.args) != 1:
                    raise PlanError(f"{e.name} takes exactly one argument")
                arg = e.args[0]
            if e.distinct and arg is None:
                raise PlanError(f"{e.name}(DISTINCT *) is meaningless")
            name = f"__agg{len(specs)}"
            specs.append(AggSpec(name, e.name, arg, distinct=e.distinct))
            col = Column(name)
            cache[e] = col
            return col
        return None
    return _transform(expr, fn)


def _copy_stmt(stmt: SelectStmt) -> SelectStmt:
    import copy as _c
    out = _c.copy(stmt)
    out.items = list(stmt.items)
    out.group_by = list(stmt.group_by)
    out.order_by = list(stmt.order_by)
    out.joins = list(stmt.joins)
    return out


def _extract_overs(expr: Expr, specs: List[Tuple[str, OverCall]],
                   cache: Dict[Expr, Column]) -> Expr:
    """Replace OVER calls with placeholder columns (``__overN``), collecting
    (placeholder, OverCall) pairs — the ``StreamExecOverAggregate`` split."""
    def fn(e: Expr) -> Optional[Expr]:
        if isinstance(e, OverCall):
            if e in cache:
                return cache[e]
            name = f"__over{len(specs)}"
            specs.append((name, e))
            col = Column(name)
            cache[e] = col
            return col
        return None
    return _transform(expr, fn)


def _rank_filter_limit(where: Optional[Expr], rn: str) -> Optional[int]:
    """Match ``rn <= N`` / ``rn < N`` / ``N >= rn`` -> N (else None)."""
    if not isinstance(where, Binary):
        return None
    op, l, r = where.op, where.left, where.right
    if isinstance(l, Column) and l.name == rn and isinstance(r, Literal) \
            and isinstance(r.value, (int, float)):
        if op == "<=":
            return int(r.value)
        if op == "<":
            return int(r.value) - 1
    if isinstance(r, Column) and r.name == rn and isinstance(l, Literal) \
            and isinstance(l.value, (int, float)):
        if op == ">=":
            return int(l.value)
        if op == ">":
            return int(l.value) - 1
    return None


def _propagated_rowtime(table, items: List[SelectItem],
                        names: List[str]) -> Optional[str]:
    """Output column name carrying the table's rowtime through a projection
    (None when the projection drops or derives over it)."""
    if table.rowtime is None:
        return None
    for it, nm in zip(items, names):
        if isinstance(it.expr, Column) and it.expr.name == table.rowtime:
            return nm
    return None


class KeyHashCollisionError(RuntimeError):
    """Two distinct composite keys hashed to the same int64 — the
    hash-combine fast path cannot represent this stream; re-run with
    ``hash_composite_keys=False`` (the object-tuple path)."""


class _CompositeKeyHasher:
    """int64 hash-combine fast path for composite keys, shared by the
    GROUP BY pre-projection (``__key``) and the branch-merge key
    (``__merge``).

    The legacy path builds a Python tuple per ROW
    (``np.fromiter((tuple(row) ...), object)``) — per-record host work on
    the aggregate ingest path.  Here each numeric component column is
    mixed through splitmix64 (``state/keyindex._mix64``, the same family
    the key index probes with) with a per-position salt and folded into
    one int64 — a handful of vectorized passes per batch.

    Collisions are CHECKED, not assumed away: a host side table keeps one
    bit-signature (and, when ``keep_components`` is set, the component
    values) per distinct hash; every batch verifies its rows against the
    table (vectorized searchsorted + lane compare) and raises
    :class:`KeyHashCollisionError` on a genuine 64-bit collision.  The
    component columns double as the split-back table for
    ``sql-key-split`` — the post-aggregate map recovers ``__k<i>``
    columns from fired hashes with one sorted-array gather.

    Non-numeric components (strings, objects) are not eligible —
    ``combine`` returns ``None`` and the caller falls back to the tuple
    path."""

    def __init__(self, keep_components: bool = False):
        self.keep_components = keep_components
        self._known = np.empty(0, np.int64)       # sorted distinct hashes
        self._sigs: List[np.ndarray] = []         # per part: uint64 lanes
        self._vals: List[np.ndarray] = []         # per part: orig values
        #: LOCKED-IN representation: the first batch decides hash-vs-tuple
        #: and every later batch must agree — a key column whose dtype
        #: drifts mid-stream (a None turning int64 into object) must not
        #: silently split one logical key into two representations
        self._mode: Optional[str] = None          # "hash" | "tuple"
        import threading
        self._lock = threading.Lock()

    def __getstate__(self):
        d = self.__dict__.copy()
        d["_lock"] = None
        return d

    def __setstate__(self, d):
        import threading
        self.__dict__.update(d)
        self._lock = threading.Lock()

    @staticmethod
    def _lane(part, n) -> Optional[np.ndarray]:
        """One component column -> uint64 bit lane; None = ineligible."""
        a = np.asarray(part)
        if a.shape != (n,):
            return None
        if a.dtype.kind == "b":
            a = a.astype(np.int64)
        if a.dtype.kind in "iu":
            return np.ascontiguousarray(a.astype(np.int64)).view(np.uint64)
        if a.dtype.kind == "f":
            f = np.ascontiguousarray(a.astype(np.float64))
            f = f + 0.0             # canonicalize -0.0 (== +0.0 in SQL)
            u = f.view(np.uint64)
            # one NaN group regardless of payload bits
            return np.where(np.isnan(f),
                            np.uint64(0x7FF8000000000000), u)
        return None

    def combine(self, parts: Sequence, n: int) -> Optional[np.ndarray]:
        """Hash ``parts`` (component columns) into int64[n]; registers new
        hashes in the side table and collision-checks the batch.  Returns
        ``None`` when any component is non-numeric (caller falls back)."""
        from flink_tpu_torch.state.keyindex import _mix64

        if self._mode == "tuple":
            return None
        lanes = []
        for i, p in enumerate(parts):
            u = self._lane(p, n)
            if u is None:
                with self._lock:
                    if self._mode == "hash":
                        raise KeyHashCollisionError(
                            f"composite key component {i} became "
                            f"non-numeric mid-stream after earlier batches "
                            f"were hashed — one representation per query; "
                            f"re-run with hash_composite_keys=False")
                    self._mode = "tuple"
                return None
            lanes.append(u)
        h = np.zeros(n, np.uint64)
        for i, u in enumerate(lanes):
            salt = np.uint64((0x9E3779B97F4A7C15 * (i + 1)) & (2**64 - 1))
            with np.errstate(over="ignore"):
                h = _mix64(h ^ _mix64(u ^ salt))
        out = h.view(np.int64).copy()
        self._check_and_register(out, lanes, parts)
        return out

    def _check_and_register(self, h: np.ndarray, lanes, parts) -> None:
        with self._lock:
            if self._mode == "tuple":
                raise KeyHashCollisionError(
                    "composite key components became numeric after earlier "
                    "batches fell back to tuples — one representation per "
                    "query; re-run with hash_composite_keys=False")
            self._mode = "hash"
        if h.size == 0:
            return
        # within-batch: rows sharing a hash must share every component lane
        # (unstable sort is fine — any occurrence's components serve as the
        # registered signature once this adjacency check passes)
        order = np.argsort(h)
        ho = h[order]
        adj = ho[1:] == ho[:-1]
        if adj.any():
            ai, bi = order[:-1][adj], order[1:][adj]
            for u in lanes:
                if (u[ai] != u[bi]).any():
                    raise KeyHashCollisionError(
                        "composite-key int64 hash collision inside a batch")
        # cross-batch: first occurrence per distinct hash vs the side table
        uniq_pos = np.concatenate([[0], np.flatnonzero(~adj) + 1])
        u_h = ho[uniq_pos]
        u_i = order[uniq_pos]
        with self._lock:
            if self._known.size:
                pos = np.searchsorted(self._known, u_h)
                safe = np.minimum(pos, self._known.size - 1)
                found = (pos < self._known.size) & (self._known[safe] == u_h)
            else:
                pos = np.zeros(u_h.size, np.int64)
                found = np.zeros(u_h.size, bool)
            for lane_idx, u in enumerate(lanes):
                if found.any() and (self._sigs[lane_idx][pos[found]]
                                    != u[u_i[found]]).any():
                    raise KeyHashCollisionError(
                        "composite-key int64 hash collision across batches")
            new = ~found
            if new.any():
                ins = pos[new]
                if not self._sigs:
                    self._sigs = [np.empty(0, np.uint64) for _ in lanes]
                    if self.keep_components:
                        self._vals = [np.empty(0, np.asarray(p).dtype)
                                      for p in parts]
                self._known = np.insert(self._known, ins, u_h[new])
                self._sigs = [np.insert(s, ins, u[u_i[new]])
                              for s, u in zip(self._sigs, lanes)]
                if self.keep_components:
                    self._vals = [np.insert(v, ins,
                                            np.asarray(p)[u_i[new]])
                                  for v, p in zip(self._vals, parts)]

    def components(self, hashes: np.ndarray) -> List[np.ndarray]:
        """Split-back: component columns for fired-row hashes (original
        dtypes, one sorted-array gather per component)."""
        h = np.asarray(hashes, np.int64)
        with self._lock:
            known, vals = self._known, list(self._vals)
        pos = np.searchsorted(known, h)
        safe = np.minimum(pos, max(known.size - 1, 0))
        if known.size == 0 or not bool((known[safe] == h).all()):
            raise KeyError(
                "composite-key hash not in this process's side table — a "
                "multi-process deployment split the pre-project and "
                "key-split maps; re-run with hash_composite_keys=False")
        return [v[safe] for v in vals]


def _dedup_by_tuple_key(stream, key_parts_fn, name: str):
    """Shared distinct lowering: add a TUPLE ``__dedup`` column (unambiguous,
    hashable for both the dedup dict and key-group routing), hash-route by it
    (at parallelism > 1 every copy of a value must meet the SAME dedup
    instance), and drop duplicates."""
    from flink_tpu_torch.datastream.api import DataStream
    from flink_tpu_torch.operators.sql_ops import DeduplicateOperator

    def add_key(cols, _fn=key_parts_fn):
        nrows = _n(cols)
        parts = _fn(cols, nrows)
        out = dict(cols)
        out["__dedup"] = np.fromiter(
            (tuple(row) for row in zip(*(p.tolist() for p in parts))),
            object, count=nrows)
        return out

    stream = stream.map(add_key, name=f"{name}-key")
    keyed = stream.key_by("__dedup")
    t = keyed._then(name, lambda: DeduplicateOperator("__dedup",
                                                      keep="first"),
                    chainable=False)
    return DataStream(stream.env, t)


def _contains_over_expr(expr: Expr) -> bool:
    specs: List[Tuple[str, OverCall]] = []
    _extract_overs(expr, specs, {})
    return bool(specs)


def _contains_agg(expr: Expr) -> bool:
    specs: List[AggSpec] = []
    _extract_aggs(expr, specs, {})
    return bool(specs)


def _agg_dtype():
    """Accumulator dtype for SQL aggregates: float32.

    JAX's planner takes float64 only under ``jax_enable_x64``; this package
    has no such switch and takes float32, JAX's default (sums are chunked
    per micro-batch + pane and tree-combined at fire time, which bounds
    error growth vs naive sequential accumulation)."""
    return torch.float32


def _make_aggregator(spec: AggSpec, value_col: str):
    dt = _agg_dtype()
    if spec.func == "SUM":
        return SumAggregator(dt)
    if spec.func == "AVG":
        return AvgAggregator(dt)
    if spec.func == "MIN":
        return MinAggregator(dt)
    if spec.func == "MAX":
        return MaxAggregator(dt)
    if spec.func == "COUNT":
        return CountAggregator()
    raise PlanError(f"unknown aggregate {spec.func}")


def _parse_window_call(call: Call, compiler: ExprCompiler) -> WindowSpec:
    args = call.args
    if not args or not isinstance(args[0], Column):
        raise PlanError(f"{call.name} first argument must be the rowtime column")
    time_col = args[0].name

    def interval_ms(e: Expr) -> int:
        if isinstance(e, Interval):
            return e.ms
        if isinstance(e, Literal) and isinstance(e.value, (int, float)):
            return int(e.value)
        raise PlanError(f"{call.name} expects INTERVAL arguments")

    if call.name == "TUMBLE":
        if len(args) != 2:
            raise PlanError("TUMBLE(rowtime, size_interval)")
        return WindowSpec("TUMBLE", time_col, interval_ms(args[1]))
    if call.name == "HOP":
        if len(args) != 3:
            raise PlanError("HOP(rowtime, slide_interval, size_interval)")
        return WindowSpec("HOP", time_col, interval_ms(args[2]),
                          slide_ms=interval_ms(args[1]))
    if call.name == "SESSION":
        if len(args) != 2:
            raise PlanError("SESSION(rowtime, gap_interval)")
        return WindowSpec("SESSION", time_col, interval_ms(args[1]))
    raise PlanError(f"unknown window function {call.name}")


class Planner:
    """Translates a parsed SELECT over one registered table to a DataStream."""

    def __init__(self, env, catalog: Mapping[str, "CatalogTable"],
                 mini_batch_rows: int = 0,
                 hash_composite_keys: bool = True,
                 cep_vectorized: str = "auto"):
        self.env = env
        self.catalog = catalog
        self.mini_batch_rows = mini_batch_rows
        #: int64 hash-combine fast path for composite GROUP BY / merge keys
        #: (collision-checked; _CompositeKeyHasher) — off = object tuples
        self.hash_composite_keys = hash_composite_keys
        #: threaded into the MATCH_RECOGNIZE CepOperator (auto|on|off);
        #: the operator's plan-time classifier decides the engine
        self.cep_vectorized = cep_vectorized
        #: rewrite-rule applications (rules.py), surfaced by EXPLAIN
        self.applied_rules: List[str] = []
        #: set when a join planned as an UNBOUNDED streaming join: the query
        #: output is a changelog (``op`` column) and must stay projection-only.
        #: Both flags describe the MOST RECENT plan() call (reset at entry)
        self._changelog_join = False
        #: set when the plan reads any unbounded table (join or not) —
        #: consumed at view/subquery boundaries so unboundedness propagates
        self._unbounded_plan = False

    def plan(self, stmt) -> QueryPlan:
        from flink_tpu_torch.sql.parser import UnionStmt
        from flink_tpu_torch.sql.rules import apply_rules

        # per-plan flags: a nested/earlier plan's changelog mode must not
        # leak into this one (UNION branches, views share the Planner)
        self._changelog_join = False
        self._unbounded_plan = False

        # ---- logical rewrite stage (PlannerBase.translate's optimize step)
        stmt = apply_rules(stmt, self.catalog, self.applied_rules)
        note = getattr(stmt, "join_order_cost", None)
        if note is not None:
            self.cost_note = note          # EXPLAIN's cost section

        if isinstance(stmt, UnionStmt):
            return self._plan_union(stmt)
        if stmt.table is None:
            raise PlanError("FROM clause is required")
        if isinstance(stmt.table, (SelectStmt, UnionStmt)):
            return self._plan_derived(stmt)
        try:
            table = self.catalog[stmt.table]
        except KeyError:
            raise PlanError(f"unknown table {stmt.table!r}; registered: "
                            f"{sorted(self.catalog)}")
        if not table.bounded:
            self._unbounded_plan = True
        if getattr(table, "changelog", False):
            # a changelog view/subquery feeds this query: same restrictions
            # and op passthrough as a direct streaming join apply
            self._changelog_join = True
        if stmt.match is not None:
            if stmt.joins:
                raise PlanError("MATCH_RECOGNIZE cannot be combined with "
                                "JOIN in one FROM clause (use a view)")
            if self._changelog_join:
                raise PlanError("MATCH_RECOGNIZE over a changelog stream "
                                "is not supported (the NFA cannot fold "
                                "-U/-D retractions); materialize the "
                                "changelog first")
            stream, table, qual_map = self._plan_match(stmt, table)
            stmt = _rewrite_qualified(stmt, qual_map)
        elif stmt.joins:
            stream, table, qual_map, ambiguous = self._plan_joins(stmt, table)
            stmt = _rewrite_qualified(stmt, qual_map, ambiguous)
        else:
            stream = table.stream()
            alias = stmt.table_alias or stmt.table
            qual_map = {(alias, c): c for c in table.columns}
            stmt = _rewrite_qualified(stmt, qual_map)
            if stmt.scan_columns is not None:
                # projection_prune rule: drop unreferenced columns at the
                # scan, before any operator carries them ("op" always
                # survives on changelogs: it is the row's change kind)
                keep = tuple(stmt.scan_columns)
                if self._changelog_join and "op" not in keep \
                        and "op" in table.columns:
                    keep = ("op",) + keep
                stream = stream.map(
                    lambda cols, _k=keep: {c: cols[c] for c in _k},
                    name=f"sql-scan-prune[{','.join(keep)}]")
                table = replace(table, columns=list(keep)) \
                    if hasattr(table, "__dataclass_fields__") else table
        schema = dict.fromkeys(table.columns)

        # ---- expand * and split aggregates out of SELECT / HAVING
        items: List[SelectItem] = []
        for it in stmt.items:
            if isinstance(it.expr, Star):
                items.extend(SelectItem(Column(c), c) for c in table.columns)
            else:
                items.append(it)

        if self._changelog_join:
            # unbounded streaming join: the result is a CHANGELOG — the op
            # column must survive projection, and row-reducing clauses have
            # no meaning over an infinite retraction stream
            if stmt.group_by or stmt.having is not None:
                raise PlanError(
                    "GROUP BY over an unbounded streaming JOIN changelog is "
                    "not supported yet; aggregate before the join or use a "
                    "windowed join")
            if stmt.order_by or stmt.limit is not None:
                raise PlanError("ORDER BY / LIMIT are not defined over an "
                                "unbounded streaming JOIN result")
            out_names_now = _output_names(items)
            if "op" not in out_names_now:
                items.insert(0, SelectItem(Column("op"), "op"))

        # ---- OVER aggregates (StreamExecOverAggregate): split out before
        # plain aggregate extraction; they append columns, not reduce rows
        over_specs: List[Tuple[str, OverCall]] = []
        over_cache: Dict[Expr, Column] = {}
        over_items = [SelectItem(_extract_overs(it.expr, over_specs,
                                                over_cache), it.alias)
                      for it in items]
        if over_specs:
            if self._changelog_join:
                raise PlanError("OVER aggregates over an unbounded streaming "
                                "JOIN changelog are not supported yet")
            return self._plan_over(stream, items, over_items, over_specs,
                                   table, stmt)

        agg_specs: List[AggSpec] = []
        agg_cache: Dict[Expr, Column] = {}
        rewritten = [SelectItem(_extract_aggs(it.expr, agg_specs, agg_cache),
                                it.alias) for it in items]
        having = (_extract_aggs(stmt.having, agg_specs, agg_cache)
                  if stmt.having is not None else None)
        if stmt.order_by and agg_cache:
            # ORDER BY SUM(x) must resolve to the same placeholder column the
            # select rewrite produced (aggregates not in SELECT are rejected
            # when the name lookup fails in _order_names)
            amap = dict(agg_cache)
            stmt.order_by = [(_transform(e, amap.get), asc)
                             for e, asc in stmt.order_by]

        # ---- classify GROUP BY entries: window call vs plain keys
        window: Optional[WindowSpec] = None
        group_keys: List[Expr] = []
        compiler = ExprCompiler(schema)
        for g in stmt.group_by:
            if isinstance(g, Call) and g.name in WINDOW_FUNCS:
                if window is not None:
                    raise PlanError("multiple window functions in GROUP BY")
                window = _parse_window_call(g, compiler)
            else:
                group_keys.append(g)

        if not agg_specs and (window or group_keys):
            raise PlanError("GROUP BY without aggregates is not supported")

        # ---- WHERE
        if stmt.where is not None:
            if _contains_agg(stmt.where):
                raise PlanError("aggregates are not allowed in WHERE")
            pred = compiler.compile(stmt.where)
            stream = stream.filter(lambda cols, _p=pred: np.asarray(
                to_column(_p(cols), _n(cols)), bool), name="sql-where")

        if self._changelog_join and agg_specs:
            raise PlanError("aggregates over an unbounded streaming JOIN "
                            "changelog are not supported yet")
        if not agg_specs:
            return self._plan_projection(stream, rewritten, table, stmt)
        return self._plan_aggregate(stream, rewritten, having, agg_specs,
                                    group_keys, window, table, stmt, compiler,
                                    orig_items=items)

    # ------------------------------------------------------------- union
    def _plan_union(self, stmt) -> QueryPlan:
        """``SELECT ... UNION [ALL] SELECT ...``: branches plan
        independently, columns align BY POSITION to the first branch's
        names, distinct unions dedup full rows (the two-input
        ``StreamExecUnion`` + dedup lowering)."""
        # mixed UNION/UNION ALL chains were restructured into nested
        # homogeneous unions by rules.union_associativity before lowering
        assert len(set(stmt.alls)) <= 1, "rewrite stage must run first"
        plans, changelog, unbounded = [], False, False
        for p in stmt.parts:
            plans.append(self.plan(p))      # plan() resets the flags...
            changelog |= self._changelog_join
            unbounded |= self._unbounded_plan
        # ...so re-assert the union of every branch's traits
        self._changelog_join = changelog
        self._unbounded_plan = unbounded
        if changelog and not all(stmt.alls):
            raise PlanError("UNION DISTINCT over a changelog stream is not "
                            "defined (deduplication would break retraction "
                            "pairing); use UNION ALL")
        base_cols = plans[0].output_columns
        streams = [plans[0].stream]
        for p in plans[1:]:
            if len(p.output_columns) != len(base_cols):
                raise PlanError(
                    f"UNION branches must have the same column count "
                    f"({len(base_cols)} vs {len(p.output_columns)})")
            s = p.stream
            if p.output_columns != base_cols:
                ren = dict(zip(p.output_columns, base_cols))

                def rename(cols, _r=ren):
                    return {_r.get(k, k): v for k, v in cols.items()}

                s = s.map(rename, name="sql-union-align")
            streams.append(s)
        out = streams[0].union(*streams[1:])

        if not all(stmt.alls):
            # UNION (distinct): drop duplicate FULL rows
            deduped = _dedup_by_tuple_key(
                out,
                lambda cols, nrows, _names=tuple(base_cols):
                [np.asarray(cols[nm]) for nm in _names],
                "sql-union-dedup")
            out = deduped.map(
                lambda cols, _names=tuple(base_cols):
                {nm: cols[nm] for nm in _names}, name="sql-union-strip")

        order_by: List[Tuple[str, bool]] = []
        for e, asc in stmt.order_by:
            if isinstance(e, Literal) and isinstance(e.value, int):
                if not 1 <= e.value <= len(base_cols):
                    raise PlanError(f"UNION ORDER BY ordinal {e.value} out "
                                    f"of range (1..{len(base_cols)})")
                order_by.append((base_cols[e.value - 1], asc))
            elif isinstance(e, Column) and e.name in base_cols:
                order_by.append((e.name, asc))
            else:
                raise PlanError("UNION ORDER BY must reference an output "
                                "column of the first branch (or an ordinal)")
        return QueryPlan(out, list(base_cols), order_by, stmt.limit)

    # --------------------------------------------------- over aggregates
    def _plan_over(self, stream, orig_items: List[SelectItem],
                   items: List[SelectItem],
                   over_specs: List[Tuple[str, OverCall]], table,
                   stmt: SelectStmt) -> QueryPlan:
        """``SELECT cols..., agg(x) OVER (PARTITION BY p ORDER BY rowtime
        [frame]) FROM t`` — rows pass through extended with frame aggregates
        (``StreamExecOverAggregate.java`` lowering; the Top-N ROW_NUMBER
        subquery shape stays on ``_try_plan_rank``)."""
        from flink_tpu_torch.datastream.api import DataStream
        from flink_tpu_torch.graph.transformations import Partitioning
        from flink_tpu_torch.operators.sql_ops import (OverAggregateOperator,
                                                       OverAggSpec)

        if stmt.group_by:
            raise PlanError("OVER aggregates cannot be combined with "
                            "GROUP BY in one SELECT (use a subquery)")
        if stmt.having is not None:
            raise PlanError("HAVING requires GROUP BY")
        for it in items:
            if _contains_agg(it.expr):
                raise PlanError("plain aggregates need GROUP BY; in an OVER "
                                "query every aggregate must have an OVER "
                                "clause")
        schema = dict.fromkeys(table.columns)
        compiler = ExprCompiler(schema)
        if stmt.where is not None:
            if _contains_agg(stmt.where) or _contains_over_expr(stmt.where):
                raise PlanError("aggregates are not allowed in WHERE")
            pred = compiler.compile(stmt.where)
            stream = stream.filter(lambda cols, _p=pred: np.asarray(
                to_column(_p(cols), _n(cols)), bool), name="sql-where")

        # ---- all OVER windows must share one partitioning + ordering
        over0 = over_specs[0][1]
        for _, oc in over_specs[1:]:
            if (oc.partition_by, oc.order_by, oc.ascending) != \
                    (over0.partition_by, over0.order_by, over0.ascending):
                raise PlanError("all OVER windows in one SELECT must share "
                                "PARTITION BY and ORDER BY")
        part_col = None
        if over0.partition_by is not None:
            if not isinstance(over0.partition_by, Column):
                raise PlanError("OVER PARTITION BY must be a plain column")
            part_col = over0.partition_by.name
        if over0.order_by is None:
            # without ORDER BY the SQL frame is the whole partition, which a
            # stream cannot produce row-by-row (the reference rejects it too)
            raise PlanError("OVER aggregates need ORDER BY <rowtime>")
        if not isinstance(over0.order_by, Column):
            raise PlanError("OVER ORDER BY must be a plain column")
        order_col = over0.order_by.name

        # ---- event-time (rowtime-ordered)
        event_time = False
        if order_col is not None:
            rowtime = table.rowtime
            if rowtime is not None and order_col != rowtime:
                raise PlanError(
                    f"OVER ORDER BY must be the table rowtime ({rowtime!r}) "
                    f"— streaming over-aggregates are time-ordered")
            if rowtime is None:
                # timestamps may already be assigned on the stream (derived
                # table), but without a known rowtime COLUMN we cannot prove
                # the ORDER BY attribute matches them — buffering by the
                # wrong attribute would silently mis-order the aggregate
                raise PlanError("OVER ORDER BY needs a time attribute with a "
                                "known rowtime column; declare a rowtime "
                                "column on the table")
            if not over0.ascending:
                raise PlanError("OVER ORDER BY on the rowtime must be ASC")
            event_time = True
            if not table.timestamps_assigned:
                stream = stream.assign_timestamps_and_watermarks(
                    table.watermark_delay_ms, timestamp_column=order_col,
                    name="sql-rowtime")

        # ---- pre-project aggregate inputs, build operator specs
        specs: List[OverAggSpec] = []
        arg_fns: List[Tuple[str, Any]] = []
        for name, oc in over_specs:
            in_col = None
            # DISTINCT over BOUNDED frames dedupes inside each frame at
            # aggregate time (the kept tail holds raw rows, so a value
            # leaving the frame re-counts correctly when another copy
            # remains); unbounded frames use first-occurrence contribution
            if oc.distinct and oc.func == "ROW_NUMBER":
                raise PlanError("ROW_NUMBER has no DISTINCT form")
            if oc.func == "ROW_NUMBER":
                if oc.args:
                    raise PlanError("ROW_NUMBER() takes no arguments")
            elif oc.func in AGG_FUNCS:
                if len(oc.args) == 1 and isinstance(oc.args[0], Star):
                    pass  # COUNT(*)
                elif len(oc.args) != 1:
                    raise PlanError(f"{oc.func} takes exactly one argument")
                else:
                    in_col = name + "_in"
                    arg_fns.append((in_col, compiler.compile(oc.args[0])))
            else:
                raise PlanError(f"{oc.func}() OVER is not supported "
                                f"(supported: {sorted(AGG_FUNCS)}, "
                                f"ROW_NUMBER)")
            specs.append(OverAggSpec(name, oc.func, in_col,
                                     rows=oc.frame_rows,
                                     range_ms=oc.frame_range_ms,
                                     is_rows=oc.frame_is_rows,
                                     distinct=oc.distinct))
        if arg_fns:
            def add_args(cols, _af=tuple(arg_fns)):
                n = _n(cols)
                out = dict(cols)
                for nm, f in _af:
                    out[nm] = to_column(f(cols), n)
                return out
            stream = stream.map(add_args, name="sql-over-args")

        factory = (lambda _s=tuple(specs), _p=part_col, _e=event_time:
                   OverAggregateOperator(list(_s), _p, event_time=_e))
        if part_col is not None:
            keyed = stream.key_by(part_col)
            t = keyed._then("sql-over-agg", factory, chainable=False)
        else:
            t = stream._then("sql-over-agg", factory,
                             partitioning=Partitioning.GLOBAL,
                             chainable=False)
        over_stream = DataStream(stream.env, t)

        # ---- final projection over (table cols + over outputs)
        post_schema = dict.fromkeys(
            list(table.columns) + [nm for nm, _ in arg_fns]
            + [name for name, _ in over_specs])
        post_compiler = ExprCompiler(post_schema)
        fns = [post_compiler.compile(it.expr) for it in items]
        names = _output_names(orig_items)

        def project(cols, _fns=fns, _names=names):
            n = _n(cols)
            return {nm: to_column(f(cols), n) for nm, f in zip(_names, _fns)}

        out = over_stream.map(project, name="sql-project")
        rowtime_out = None
        if event_time:
            for it, nm in zip(items, names):
                if isinstance(it.expr, Column) and it.expr.name == order_col:
                    rowtime_out = nm
                    break
        return QueryPlan(out, names, _order_names(stmt, items, names),
                         stmt.limit, rowtime=rowtime_out,
                         timestamps_assigned=rowtime_out is not None)

    # ------------------------------------------------------- derived tables
    def _plan_derived(self, stmt: SelectStmt) -> QueryPlan:
        """FROM (SELECT ...): plan the subquery, then the outer query over
        its output; the blink Top-N pattern (ROW_NUMBER + rn <= N filter)
        lowers to the TopN operator (``StreamExecRank``)."""
        from flink_tpu_torch.sql.table_env import CatalogTable

        rank = self._try_plan_rank(stmt)
        if rank is not None:
            return rank
        inner = self.plan(stmt.table)
        # the nested plan() just set the flags for the SUBQUERY — capture
        # its traits before the outer plan() resets them, so unboundedness
        # and changelog-ness survive the subquery boundary
        inner_changelog = self._changelog_join
        inner_unbounded = self._unbounded_plan
        inner_stream = inner.stream
        if inner.order_by or inner.limit is not None:
            # a subquery's ORDER BY/LIMIT are part of ITS result set — apply
            # them in-stream before the outer query consumes the rows
            from flink_tpu_torch.operators.sql_ops import SortLimitOperator
            from flink_tpu_torch.datastream.api import DataStream
            t = inner_stream._then(
                "sql-sort-limit",
                lambda _ob=tuple(inner.order_by), _lim=inner.limit:
                SortLimitOperator(list(_ob), _lim), chainable=False)
            inner_stream = DataStream(inner_stream.env, t)
        # propagate the time attribute: the outer query may only use event
        # time if the subquery's projection carried the rowtime through
        # (the reference's rowtime-propagation rule)
        sub = CatalogTable(name="<subquery>",
                           columns=list(inner.output_columns),
                           stream_factory=lambda env: inner_stream,
                           rowtime=inner.rowtime,
                           timestamps_assigned=inner.timestamps_assigned,
                           bounded=not inner_unbounded,
                           changelog=inner_changelog)
        outer = _copy_stmt(stmt)
        outer.table = "<subquery>"
        outer.table_alias = stmt.table_alias
        saved = self.catalog
        self.catalog = dict(saved)
        self.catalog["<subquery>"] = sub
        try:
            return self.plan(outer)
        finally:
            self.catalog = saved

    def _try_plan_rank(self, stmt: SelectStmt) -> Optional[QueryPlan]:
        inner = stmt.table
        if not isinstance(inner, SelectStmt):
            return None  # a UNION subquery cannot be the Top-N shape
        over_items = [(i, it) for i, it in enumerate(inner.items)
                      if isinstance(it.expr, OverCall)]
        if not any(it.expr.func == "ROW_NUMBER" for _, it in over_items):
            # not the Top-N shape — fall through to generic derived-table
            # planning, where _plan_over handles OVER aggregates
            return None
        if len(over_items) != 1:
            raise PlanError("ROW_NUMBER Top-N allows exactly one window "
                            "function in the subquery")
        idx, over_it = over_items[0]
        over: OverCall = over_it.expr
        if over.order_by is None or not isinstance(over.order_by, Column):
            raise PlanError("ROW_NUMBER OVER needs ORDER BY <column>")
        if over.partition_by is not None and \
                not isinstance(over.partition_by, Column):
            raise PlanError("PARTITION BY must be a plain column")
        rn = over_it.alias or "rn"
        n = _rank_filter_limit(stmt.where, rn)
        if n is None:
            raise PlanError(
                f"Top-N needs an outer filter of the form {rn} <= N")
        # plan the base subquery WITHOUT the over item
        base = _copy_stmt(inner)
        base.items = [it for i, it in enumerate(inner.items) if i != idx]
        base_plan = self.plan(base)
        part_col = over.partition_by.name if over.partition_by else None
        order_col = over.order_by.name
        for c in filter(None, (part_col, order_col)):
            if c not in base_plan.output_columns:
                raise PlanError(f"rank column {c!r} must be selected in the "
                                f"subquery (have {base_plan.output_columns})")
        from flink_tpu_torch.datastream.api import DataStream
        from flink_tpu_torch.graph.transformations import Partitioning
        from flink_tpu_torch.operators.sql_ops import TopNOperator

        stream = base_plan.stream
        factory = (lambda _n=n, _p=part_col, _o=order_col,
                   _a=over.ascending: TopNOperator(
                       _n, _p, _o, ascending=_a, emit_changelog=False))
        if part_col is not None:
            keyed = stream.key_by(part_col)
            t = keyed._then("sql-rank", factory, chainable=False)
        else:
            t = stream._then("sql-rank", factory,
                            partitioning=Partitioning.GLOBAL, chainable=False)
        ranked = DataStream(stream.env, t)

        # rank column rename + outer projection over base cols + rn
        def add_rn(cols, _rn=rn):
            out = dict(cols)
            out[_rn] = out.pop("rank")
            out.pop("op", None)
            return out

        ranked = ranked.map(add_rn, name="sql-rank-name")
        out_cols = base_plan.output_columns + [rn]
        outer_items = []
        for it in stmt.items:
            if isinstance(it.expr, Star):
                outer_items.extend(SelectItem(Column(c), c) for c in out_cols)
            else:
                outer_items.append(it)
        schema = dict.fromkeys(out_cols)
        compiler = ExprCompiler(schema)
        fns = [compiler.compile(it.expr) for it in outer_items]
        names = _output_names(outer_items)

        def project(cols, _fns=fns, _names=names):
            nrows = _n(cols)
            return {nm: to_column(f(cols), nrows)
                    for nm, f in zip(_names, _fns)}

        out = ranked.map(project, name="sql-project")
        return QueryPlan(out, names, _order_names(stmt, outer_items, names),
                         stmt.limit)

    # --------------------------------------------------- MATCH_RECOGNIZE
    def _plan_match(self, stmt: SelectStmt, table):
        """Lower ``MATCH_RECOGNIZE`` onto the CEP NFA operator — the
        ``StreamExecMatch.java:90`` → ``CepOperator`` path.  PATTERN
        variables become strict-contiguity NFA stages (a row not attributed
        to any variable kills the attempt, unlike CEP's relaxed
        ``followedBy``); DEFINE conditions compile to vectorized columnar
        closures with ``PREV(col)`` resolved to a drain-time
        ``__prev_<col>`` column; MEASURES evaluate per match."""
        from flink_tpu_torch.cep.operator import CepOperator
        from flink_tpu_torch.cep.pattern import (AfterMatchSkipStrategy,
                                                 Pattern, Stage)
        from flink_tpu_torch.datastream.api import DataStream
        from flink_tpu_torch.sql.table_env import CatalogTable

        mr = stmt.match
        if len(mr.partition_by) > 1:
            raise PlanError("MATCH_RECOGNIZE supports a single PARTITION BY "
                            "column")
        for c in mr.partition_by + [mr.order_by]:
            if c not in table.columns:
                raise PlanError(f"MATCH_RECOGNIZE: unknown column {c!r}")
        if table.rowtime is not None and mr.order_by != table.rowtime:
            raise PlanError(f"MATCH_RECOGNIZE ORDER BY must be the rowtime "
                            f"column {table.rowtime!r}")
        var_names = [st.var.upper() for st in mr.pattern]
        if len(set(var_names)) != len(var_names):
            raise PlanError("duplicate PATTERN variable")
        for v in mr.defines:
            if v not in var_names:
                raise PlanError(f"DEFINE names unknown variable {v!r}")

        prev_cols: List[str] = []
        stages: List[Stage] = []
        cond_schema = dict.fromkeys(
            list(table.columns) + [f"__prev_{c}" for c in table.columns])
        for st in mr.pattern:
            cond = None
            cexpr = mr.defines.get(st.var.upper())
            if cexpr is not None:
                rewritten = self._rewrite_match_define(
                    cexpr, set(var_names), table.columns, prev_cols)
                fn = ExprCompiler(cond_schema).compile(rewritten)
                cond = (lambda cols, _f=fn: np.asarray(
                    to_column(_f(cols), _n(cols)), bool))
            stages.append(Stage(
                st.var.upper(), condition=cond, contiguity="strict",
                times_min=max(st.quant_min, 1),
                # {0,n} / {0,}: a zero lower bound means the variable may
                # match no rows at all — optional, not mandatory-once
                times_max=st.quant_max,
                optional=st.optional or st.quant_min == 0,
                # SQL quantifiers are greedy by default: a looping variable
                # takes every row it can before the next variable starts
                greedy=(st.quant_max is None
                        or st.quant_max != st.quant_min)))
        pattern = Pattern(
            stages, within_ms=mr.within_ms,
            skip_strategy=(AfterMatchSkipStrategy.SKIP_PAST_LAST_EVENT
                           if mr.after_match == "skip_past_last"
                           else AfterMatchSkipStrategy.NO_SKIP))

        part = mr.partition_by[0] if mr.partition_by else None
        measure_names, measure_exprs = [], []
        vset = set(var_names)
        for it in mr.measures:
            self._validate_measure(it.expr, vset, table.columns)
            measure_names.append(it.alias or expr_name(it.expr))
            measure_exprs.append(it.expr)
        out_cols = ([part] if part else []) + measure_names
        select_fn = _make_measure_fn(measure_names, measure_exprs,
                                     var_names, part)

        stream = table.stream()
        if not table.timestamps_assigned:
            stream = stream.assign_timestamps_and_watermarks(
                table.watermark_delay_ms, timestamp_column=mr.order_by,
                name="sql-match-rowtime")
        if part is None:
            # no PARTITION BY: one global NFA (constant key, dropped after)
            stream = stream.map(
                lambda cols: {**cols, "__match_pk": np.zeros(
                    _n(cols), np.int64)}, name="sql-match-global-key")
            key_col = "__match_pk"
        else:
            key_col = part
        keyed = stream.key_by(key_col)
        t = keyed._then(
            "sql-match-recognize",
            lambda _p=pattern, _k=key_col, _s=select_fn, _pc=list(prev_cols),
            _oc=mr.order_by, _v=self.cep_vectorized, _env=keyed.env:
            CepOperator(_p, _k, _s, name="sql-match-recognize",
                        defer_conditions=True, prev_columns=_pc,
                        leftmost_order_column=_oc, vectorized=_v,
                        device=_env.operator_device()),
            chainable=False)
        out_stream = DataStream(keyed.env, t)
        alias = mr.alias or stmt.table_alias or stmt.table
        qual_map = {(alias, c): c for c in out_cols}
        out_table = CatalogTable(name="<match>", columns=out_cols,
                                 stream_factory=lambda env: out_stream,
                                 timestamps_assigned=True,
                                 bounded=table.bounded)
        if not table.bounded:
            self._unbounded_plan = True
        return out_stream, out_table, qual_map

    def _validate_measure(self, expr: Expr, var_names: set,
                          columns: List[str]) -> None:
        """Plan-time checks for MEASURES: every variable qualifier must be a
        PATTERN variable and every column must exist (runtime evaluation is
        per-match and would surface these lazily otherwise)."""
        def fn(e: Expr):
            if isinstance(e, Column) and e.table is not None:
                if e.table.upper() not in var_names:
                    raise PlanError(f"{e.table}.{e.name}: unknown pattern "
                                    f"variable in MEASURES")
                if e.name not in columns:
                    raise PlanError(f"MEASURES: unknown column {e.name!r}")
            return None
        _transform(expr, fn)

    def _rewrite_match_define(self, expr: Expr, var_names: set,
                              columns: List[str],
                              prev_cols: List[str]) -> Expr:
        """DEFINE condition rewrite: strip pattern-variable qualifiers
        (``DOWN.price`` = the CURRENT row's price) and resolve
        ``PREV(col)`` to the drain-time ``__prev_<col>`` column."""
        def fn(e: Expr):
            if isinstance(e, Call) and e.name == "PREV":
                if len(e.args) == 2:
                    off = e.args[1]
                    if not (isinstance(off, Literal) and off.value == 1):
                        raise PlanError("PREV with offset > 1 is not "
                                        "supported")
                elif len(e.args) != 1:
                    raise PlanError("PREV takes a column (and optional "
                                    "offset 1)")
                arg = e.args[0]
                if not isinstance(arg, Column):
                    raise PlanError("PREV argument must be a column")
                if arg.name not in columns:
                    raise PlanError(f"PREV: unknown column {arg.name!r}")
                if arg.name not in prev_cols:
                    prev_cols.append(arg.name)
                return Column(f"__prev_{arg.name}")
            if isinstance(e, Call) and e.name in ("FIRST", "LAST"):
                raise PlanError(f"{e.name} is only supported in MEASURES, "
                                f"not DEFINE")
            if isinstance(e, Column) and e.table is not None:
                if e.table.upper() not in var_names:
                    raise PlanError(f"{e.table}.{e.name}: unknown pattern "
                                    f"variable in DEFINE")
                if e.name not in columns:
                    raise PlanError(f"DEFINE: unknown column {e.name!r}")
                return Column(e.name)
            return None
        return _transform(expr, fn)

    # ------------------------------------------------------------ joins
    def _plan_joins(self, stmt: SelectStmt, base):
        """FROM a JOIN b ON ... — equi-joins chained left-deep.

        Bounded inputs lower to ``SqlJoinOperator`` (``StreamExecJoin`` over
        bounded inputs: emit at end of input).  If ANY input is unbounded,
        every join in the chain lowers to the incremental
        ``StreamingJoinOperator`` instead (``StreamExecJoin.java:61`` →
        ``StreamingJoinOperator.java:36``): both sides live in keyed state
        and the result is a changelog with an ``op`` column."""
        from flink_tpu_torch.datastream.api import DataStream
        from flink_tpu_torch.graph.transformations import (Partitioning,
                                                           Transformation)
        from flink_tpu_torch.operators.sql_ops import (SqlJoinOperator,
                                                       StreamingJoinOperator)
        from flink_tpu_torch.sql.table_env import CatalogTable

        def _traits(t):
            return (not t.bounded) or getattr(t, "changelog", False)

        streaming = _traits(base) or any(
            _traits(self.catalog[jc.table])
            for jc in stmt.joins if jc.table in self.catalog)
        if streaming:
            self._unbounded_plan = True
        #: does the stream AT THIS POINT of the chain carry changelog rows?
        #: (regular streaming joins produce changelogs; temporal/lookup
        #: joins keep append-only rows and cannot consume changelogs)
        changelog_now = getattr(base, "changelog", False)

        # a changelog input's "op" column is the row's change kind, not
        # data: the join operator consumes it (retract on -D/-U) and must
        # not store or re-emit it as a payload column
        base_data_cols = [c for c in base.columns
                          if not (c == "op"
                                  and getattr(base, "changelog", False))]
        cur_stream = base.stream()
        if stmt.scan_filter is not None:
            # filter_pushdown rule: base-side WHERE conjuncts run pre-join
            cur_stream = self._pre_filter(cur_stream, base.columns,
                                          stmt.scan_filter,
                                          f"sql-prejoin-filter:{stmt.table}")
        a0 = stmt.table_alias or stmt.table
        qual_map: Dict[Tuple[str, str], str] = {(a0, c): c
                                                for c in base_data_cols}
        out_names: List[str] = list(base_data_cols)
        ambiguous: set = set()
        for jc in stmt.joins:
            try:
                rt = self.catalog[jc.table]
            except KeyError:
                raise PlanError(f"unknown table {jc.table!r} in JOIN")
            ralias = jc.alias or jc.table
            left_names = list(out_names)   # columns of the LEFT side only
            rt_data_cols = [c for c in rt.columns
                            if not (c == "op"
                                    and getattr(rt, "changelog", False))]
            rename: Dict[str, str] = {}
            for c in rt_data_cols:
                nm = c if c not in out_names else f"{ralias}_{c}"
                while nm in out_names:
                    nm += "_"
                if nm != c:
                    ambiguous.add(c)
                rename[c] = nm
                qual_map[(ralias, c)] = nm
                out_names.append(nm)
            lk, rk = self._resolve_equi_on(jc.on, qual_map, rt, ralias,
                                           left_names)
            if jc.system_time_of is not None:
                if changelog_now:
                    raise PlanError("temporal/lookup join over a changelog "
                                    "input is not supported (put the "
                                    "FOR SYSTEM_TIME join before the "
                                    "regular join)")
                first_join = left_names == list(base_data_cols)
                cur_stream = self._plan_system_time_join(
                    jc, rt, cur_stream, lk, rk, dict(rename),
                    list(left_names), list(rt_data_cols), qual_map,
                    base if first_join else None)
                continue
            rstream = rt.stream()
            if jc.pre_filter is not None:
                rstream = self._pre_filter(rstream, rt.columns, jc.pre_filter,
                                           f"sql-prejoin-filter:{jc.table}")
            cls = StreamingJoinOperator if streaming else SqlJoinOperator
            op_cls = (lambda _cls=cls, _lk=lk, _rk=rk, _how=jc.kind,
                      _rn=dict(rename), _lc=list(left_names),
                      _rc=list(rt_data_cols), _d=self.env.device:
                      _cls(_lk, _rk, _how, _rn, left_columns=_lc,
                           right_columns=_rc, device=_d))
            t = Transformation(
                name=(f"sql-streaming-join:{jc.table}" if streaming
                      else f"sql-join:{jc.table}"),
                operator_factory=op_cls,
                inputs=[cur_stream.transformation, rstream.transformation],
                input_partitionings=[Partitioning.HASH, Partitioning.HASH],
                input_key_columns=[lk, rk],
                parallelism=self.env.parallelism, chainable=False,
                max_parallelism=self.env.max_parallelism)
            cur_stream = DataStream(self.env, t)
            if streaming:
                changelog_now = True
        self._changelog_join = changelog_now
        if changelog_now:
            if "op" in out_names:
                raise PlanError("streaming JOIN inputs must not have a "
                                "column named 'op' (reserved for the "
                                "changelog kind)")
            out_names = ["op"] + out_names
        joined = CatalogTable(name="<join>", columns=out_names,
                              stream_factory=lambda env: cur_stream,
                              timestamps_assigned=False,
                              bounded=not streaming,
                              changelog=changelog_now)
        return cur_stream, joined, qual_map, ambiguous

    def _plan_system_time_join(self, jc, rt, cur_stream, lk: str, rk: str,
                               rename: Dict[str, str],
                               left_names: List[str], rt_cols: List[str],
                               qual_map, base_if_first):
        """``JOIN t FOR SYSTEM_TIME AS OF <time>`` — two shapes:

        - ``t`` registered as a LOOKUP table → ``LookupJoinOperator``
          (``StreamExecLookupJoin``): per-key external probe with TTL cache,
          observed at processing time.
        - ``t`` a regular table with a rowtime → ``TemporalJoinOperator``
          (``StreamExecTemporalJoin.java:67``): event-time versioned join,
          each left row sees the version valid at its time attribute."""
        from flink_tpu_torch.datastream.api import DataStream
        from flink_tpu_torch.graph.transformations import (Partitioning,
                                                           Transformation)
        from flink_tpu_torch.operators.sql_ops import (LookupJoinOperator,
                                                       TemporalJoinOperator)

        if jc.kind not in ("inner", "left"):
            raise PlanError("FOR SYSTEM_TIME joins support INNER and LEFT "
                            "only")
        if getattr(rt, "lookup", None) is not None:
            lk_col = getattr(rt, "lookup_key", None)
            if lk_col is not None and rk != lk_col:
                raise PlanError(f"lookup table {rt.name!r} is keyed by "
                                f"{lk_col!r}; the join must be ON "
                                f"left.col = {rt.name}.{lk_col}")
            t = Transformation(
                name=f"sql-lookup-join:{jc.table}",
                operator_factory=(
                    lambda _lk=lk, _fn=rt.lookup, _rc=list(rt_cols),
                    _rn=dict(rename), _how=jc.kind,
                    _ttl=rt.lookup_cache_ttl_ms:
                    LookupJoinOperator(_lk, _fn, _rc, _rn, _how,
                                       cache_ttl_ms=_ttl)),
                inputs=[cur_stream.transformation],
                input_partitionings=[Partitioning.HASH],
                input_key_columns=[lk],
                parallelism=self.env.parallelism, chainable=False,
                max_parallelism=self.env.max_parallelism)
            return DataStream(self.env, t)

        if rt.rowtime is None:
            raise PlanError(f"temporal join: table {jc.table!r} must "
                            f"declare a rowtime column (its version time), "
                            f"or be registered as a lookup table")
        st = jc.system_time_of
        if not isinstance(st, Column):
            raise PlanError("FOR SYSTEM_TIME AS OF must name a left-side "
                            "time column")
        if st.table is not None:
            key = (st.table, st.name)
            if key not in qual_map:
                raise PlanError(f"{st.table}.{st.name}: unknown in "
                                f"FOR SYSTEM_TIME AS OF")
            ltime = qual_map[key]
        else:
            ltime = st.name
        if ltime not in left_names:
            raise PlanError(f"FOR SYSTEM_TIME AS OF column {ltime!r} is not "
                            f"on the left side")
        if base_if_first is not None \
                and not base_if_first.timestamps_assigned:
            # drive the valve: left watermarks gate the buffered emission
            cur_stream = cur_stream.assign_timestamps_and_watermarks(
                base_if_first.watermark_delay_ms, timestamp_column=ltime,
                name="sql-temporal-left-rowtime")
        rstream = rt.stream()
        if not rt.timestamps_assigned:
            rstream = rstream.assign_timestamps_and_watermarks(
                rt.watermark_delay_ms, timestamp_column=rt.rowtime,
                name=f"sql-temporal-version-rowtime:{jc.table}")
        t = Transformation(
            name=f"sql-temporal-join:{jc.table}",
            operator_factory=(
                lambda _lk=lk, _rk=rk, _lt=ltime, _rt=rt.rowtime,
                _rc=list(rt_cols), _rn=dict(rename), _how=jc.kind:
                TemporalJoinOperator(_lk, _rk, _lt, _rt, _rc, _rn, _how)),
            inputs=[cur_stream.transformation, rstream.transformation],
            input_partitionings=[Partitioning.HASH, Partitioning.HASH],
            input_key_columns=[lk, rk],
            parallelism=self.env.parallelism, chainable=False,
            max_parallelism=self.env.max_parallelism)
        return DataStream(self.env, t)

    def _pre_filter(self, stream, columns, pred_expr: Expr, name: str):
        """Apply a pushed-down predicate (bare column names) to an input."""
        pred = ExprCompiler(dict.fromkeys(columns)).compile(pred_expr)
        return stream.filter(
            lambda cols, _p=pred: np.asarray(to_column(_p(cols), _n(cols)),
                                             bool), name=name)

    def _resolve_equi_on(self, on: Expr, qual_map, right_table, ralias: str,
                         left_names: List[str]) -> Tuple[str, str]:
        if not (isinstance(on, Binary) and on.op == "="
                and isinstance(on.left, Column)
                and isinstance(on.right, Column)):
            raise PlanError("JOIN ... ON must be an equi-join between two "
                            "columns (a.k = b.k)")

        def side(col: Column) -> Tuple[str, str]:
            """-> ('right', original right col) or ('left', output name)."""
            if col.table == ralias:
                if col.name not in right_table.columns:
                    raise PlanError(f"{ralias}.{col.name}: no such column")
                return "right", col.name
            if col.table is not None:
                key = (col.table, col.name)
                if key not in qual_map:
                    raise PlanError(f"{col.table}.{col.name}: unknown")
                return "left", qual_map[key]
            # unqualified: resolve by uniqueness across the two sides
            in_left = col.name in left_names
            in_right = col.name in right_table.columns
            if in_left and in_right:
                raise PlanError(f"column {col.name!r} is ambiguous in JOIN "
                                f"(qualify it: {ralias}.{col.name})")
            if in_right:
                return "right", col.name
            if in_left:
                return "left", col.name
            raise PlanError(f"column {col.name!r} not found in JOIN")

        s1, c1 = side(on.left)
        s2, c2 = side(on.right)
        if {s1, s2} != {"left", "right"}:
            raise PlanError("JOIN condition must relate the two tables")
        return (c1, c2) if s1 == "left" else (c2, c1)

    # ------------------------------------------------------------ projection
    def _plan_projection(self, stream, items: List[SelectItem], table,
                         stmt: SelectStmt) -> QueryPlan:
        compiler = ExprCompiler(dict.fromkeys(table.columns))
        names = _output_names(items)
        fns = [compiler.compile(it.expr) for it in items]

        def project(cols, _fns=fns, _names=names):
            n = _n(cols)
            return {nm: to_column(f(cols), n) for nm, f in zip(_names, _fns)}

        out = stream.map(project, name="sql-project")
        rowtime_out = _propagated_rowtime(table, items, names)
        return QueryPlan(out, names, _order_names(stmt, items, names),
                         stmt.limit, rowtime=rowtime_out,
                         timestamps_assigned=(rowtime_out is not None
                                              and table.timestamps_assigned))

    # ------------------------------------------------------------- aggregate
    def _plan_aggregate(self, stream, items, having, agg_specs: List[AggSpec],
                        group_keys: List[Expr], window: Optional[WindowSpec],
                        table, stmt: SelectStmt, compiler: ExprCompiler,
                        orig_items: Optional[List[SelectItem]] = None) -> QueryPlan:
        # ---- event time for windowed queries
        if window is not None:
            rowtime = table.rowtime
            if rowtime is not None and rowtime != window.time_col:
                raise PlanError(
                    f"window is over {window.time_col!r} but table rowtime is "
                    f"{rowtime!r}")
            if not table.timestamps_assigned:
                stream = stream.assign_timestamps_and_watermarks(
                    table.watermark_delay_ms, timestamp_column=window.time_col,
                    name="sql-rowtime")

        # ---- DISTINCT aggregates: dedup-then-aggregate (the classic
        # two-phase expansion of COUNT(DISTINCT x) GROUP BY k: drop duplicate
        # (k[, window], x) rows, then aggregate normally).  Mixed queries
        # split into a plain branch and a distinct branch whose fired rows
        # re-merge on (key[, window]) — the reference folds both into one
        # AggsHandleFunction with distinct-state MapViews instead.
        distinct_specs = [s for s in agg_specs if s.distinct]
        plain_specs = [s for s in agg_specs if not s.distinct]
        if distinct_specs:
            args = {repr(s.arg) for s in distinct_specs}
            if len(args) != 1:
                raise PlanError("all DISTINCT aggregates in a query must "
                                "share the same argument")

        key_exprs = group_keys
        single_col_key = (len(key_exprs) == 1 and isinstance(key_exprs[0], Column))
        key_col = key_exprs[0].name if single_col_key else "__key"
        emit_bounds = window is not None
        # ONE hasher per aggregate plan, shared by every branch's
        # pre-projection AND the post-aggregate key split — both branches
        # register into the same side table, so split_key can never consult
        # a table the other branch filled
        self._key_hasher = (_CompositeKeyHasher(keep_components=True)
                            if self.hash_composite_keys and not single_col_key
                            and len(key_exprs) > 1 else None)

        if distinct_specs and window is not None and window.kind == "SESSION":
            # merging windows have no stable identity a row-level dedup key
            # could name — instead ONE session operator carries per-session
            # distinct-value SETS that merge with the intervals
            # (SessionWindowOperator.distinct_specs, the MapView analog)
            agg_stream = self._agg_branch(stream, agg_specs, key_exprs,
                                          key_col, single_col_key, window,
                                          compiler, None,
                                          session_distinct=distinct_specs)
            return self._post_aggregate(agg_stream, items, having, agg_specs,
                                        key_exprs, single_col_key, key_col,
                                        emit_bounds, stmt, orig_items)

        if distinct_specs and plain_specs:
            a = self._agg_branch(stream, plain_specs, key_exprs, key_col,
                                 single_col_key, window, compiler, None)
            b = self._distinct_branch(stream, distinct_specs, key_exprs,
                                      key_col, single_col_key, window,
                                      compiler)
            agg_stream = self._merge_branches(
                a, b, key_col, emit_bounds,
                extra=[s.out_name for s in distinct_specs])
        elif distinct_specs:
            agg_stream = self._distinct_branch(stream, distinct_specs,
                                               key_exprs, key_col,
                                               single_col_key, window,
                                               compiler)
        else:
            agg_stream = self._agg_branch(stream, agg_specs, key_exprs,
                                          key_col, single_col_key, window,
                                          compiler, None)

        return self._post_aggregate(agg_stream, items, having, agg_specs,
                                    key_exprs, single_col_key, key_col,
                                    emit_bounds, stmt, orig_items)

    def _distinct_branch(self, stream, distinct_specs: List[AggSpec],
                         key_exprs: List[Expr], key_col: str,
                         single_col_key: bool,
                         window: Optional[WindowSpec],
                         compiler: ExprCompiler):
        """The DISTINCT pipeline.  HOP windows first EXPAND each row into
        per-covering-window copies on a synthetic per-window timestamp
        (``HopWindowExpandOperator``) so the window identity becomes part
        of the row — then the TUMBLE machinery applies unchanged; the real
        HOP bounds are recovered from the synthetic bucket afterwards."""
        from flink_tpu_torch.datastream.api import DataStream

        if window is not None and window.kind == "HOP":
            from flink_tpu_torch.operators.sql_ops import (
                HopWindowExpandOperator)

            size, slide = window.size_ms, window.slide_ms
            t = stream._then(
                "sql-hop-expand",
                lambda _s=size, _sl=slide: HopWindowExpandOperator(_s, _sl),
                chainable=False)
            expanded = DataStream(stream.env, t)
            # offset aligns bucket boundaries on the REAL window closes
            # (w*slide + size): every synthetic bucket ends exactly when
            # its HOP window does, so the late-drop rule matches the plain
            # branch for ANY size/slide (incl. size not a multiple of
            # slide)
            synth = WindowSpec(kind="TUMBLE", time_col="__hopts",
                               size_ms=slide, offset_ms=size % slide)
            out = self._agg_branch(expanded, distinct_specs, key_exprs,
                                   key_col, single_col_key, synth, compiler,
                                   distinct_specs[0].arg)
            shift = size - slide  # bucket [w*slide+size-slide, w*slide+size)

            def fix_bounds(cols, _shift=shift, _size=size):
                o = dict(cols)
                start = np.asarray(o["window_start"], np.int64) - _shift
                o["window_start"] = start
                o["window_end"] = start + _size
                return o

            return out.map(fix_bounds, name="sql-hop-bounds")
        return self._agg_branch(stream, distinct_specs, key_exprs, key_col,
                                single_col_key, window, compiler,
                                distinct_specs[0].arg)

    def _agg_branch(self, stream, agg_specs: List[AggSpec],
                    key_exprs: List[Expr], key_col: str,
                    single_col_key: bool, window: Optional[WindowSpec],
                    compiler: ExprCompiler, dedup_arg: Optional[Expr],
                    session_distinct: Optional[List[AggSpec]] = None):
        """One aggregate pipeline: [dedup →] pre-project → key_by → window
        aggregate, returning the fired-rows stream.  ``session_distinct``:
        DISTINCT specs handled by the session operator's per-session sets
        (excluded from the ACC pytree)."""
        from flink_tpu_torch.datastream.api import DataStream

        if dedup_arg is not None:
            dk_fns = ([compiler.compile(k) for k in key_exprs]
                      + [compiler.compile(dedup_arg)])
            win = window

            def key_parts(cols, nrows, _fns=dk_fns, _w=win):
                parts = [to_column(f(cols), nrows) for f in _fns]
                if _w is not None:
                    # TUMBLE: the dedup scope is one window — fold the
                    # window index into the key so a value recurring in a
                    # LATER window still counts there
                    widx = ((np.asarray(cols[_w.time_col], np.int64)
                             - _w.offset_ms) // _w.size_ms)
                    parts = parts[:-1] + [widx, parts[-1]]
                return parts

            stream = _dedup_by_tuple_key(stream, key_parts,
                                         "sql-distinct-dedup")

        # ---- pre-projection: aggregate inputs + computed/composite group key
        key_fns = [compiler.compile(k) for k in key_exprs]
        arg_fns = [(s.out_name + "_in", compiler.compile(s.arg))
                   for s in agg_specs if s.arg is not None]
        need_ones = any(s.arg is None for s in agg_specs)

        hasher = getattr(self, "_key_hasher", None)

        def pre_project(cols, _kf=key_fns, _af=arg_fns,
                        _composite=not single_col_key, _ones=need_ones,
                        _h=hasher):
            n = _n(cols)
            out = dict(cols)
            for nm, f in _af:
                out[nm] = to_column(f(cols), n)
            if _ones:
                out["__ones"] = np.ones(n, np.int32)
            if _composite:
                if len(_kf) == 0:
                    out["__key"] = np.zeros(n, np.int64)  # global aggregate
                elif len(_kf) == 1:
                    out["__key"] = to_column(_kf[0](cols), n)
                else:
                    parts = [to_column(f(cols), n) for f in _kf]
                    # int64 hash-combine fast path (collision-checked) —
                    # numeric keys skip the per-row Python tuple build
                    key = _h.combine(parts, n) if _h is not None else None
                    if key is None:
                        key = np.fromiter(
                            (tuple(row)
                             for row in zip(*(p.tolist() for p in parts))),
                            object, count=n)
                    out["__key"] = key
            return out

        stream = stream.map(pre_project, name="sql-pre-project")
        if self.mini_batch_rows:
            # bundle small batches ahead of the stateful aggregate
            # (``table.exec.mini-batch`` bundling, ``operators/bundle/``)
            from flink_tpu_torch.operators.sql_ops import MiniBatchOperator
            mbr = self.mini_batch_rows
            t = stream._then("sql-mini-batch",
                             lambda: MiniBatchOperator(mbr),
                             chainable=False)
            stream = DataStream(stream.env, t)
        keyed = stream.key_by(key_col)

        # ---- the aggregate handler: one ACC pytree for all aggregates.
        # The value selector passes ONLY numeric input columns — the update
        # step runs on the device, and key/string columns stay host-side.
        distinct_names = {s.out_name for s in (session_distinct or [])}
        agg_map: Dict[str, Tuple[str, Any]] = {}
        for s in agg_specs:
            if s.out_name in distinct_names:
                continue   # handled by the session operator's value sets
            in_col = s.out_name + "_in" if s.arg is not None else "__ones"
            agg_map[s.out_name] = (in_col, _make_aggregator(s, in_col))
        tuple_agg = TupleAggregator(agg_map)
        needed = {c for c, _ in agg_map.values()}
        if session_distinct:
            needed.add(session_distinct[0].out_name + "_in")
        needed = sorted(needed)
        select_values = lambda c, _need=tuple(needed): {k: c[k] for k in _need}  # noqa: E731

        if window is None:
            assigner = GlobalWindows()
            assigner.is_event_time = False  # fire only at end-of-input
            from flink_tpu_torch.operators.window_agg import WindowAggOperator
            from flink_tpu_torch.windowing.triggers import EventTimeTrigger

            def factory(_a=assigner, _agg=tuple_agg, _k=key_col,
                        _env=keyed.env):
                return WindowAggOperator(
                    _a, _agg, key_column=_k, value_selector=select_values,
                    trigger=EventTimeTrigger(), emit_window_bounds=False,
                    name="sql-group-agg", device=_env.operator_device())
            t = keyed._then("sql-group-agg", factory)
            return DataStream(keyed.env, t)
        if window.kind == "SESSION":
            if session_distinct:
                from flink_tpu_torch.operators.session_window import (
                    SessionWindowOperator)
                assigner = EventTimeSessionWindows(window.size_ms)
                dspecs = {s.out_name: s.func for s in session_distinct}
                dcol = session_distinct[0].out_name + "_in"
                mesh = keyed.env.mesh

                def factory(_a=assigner, _agg=tuple_agg, _k=key_col,
                            _ds=dspecs, _dc=dcol, _m=mesh):
                    kwargs = dict(key_column=_k,
                                  value_selector=select_values,
                                  name="sql-session-agg",
                                  distinct_specs=dict(_ds),
                                  distinct_column=_dc)
                    if _m is not None:
                        from flink_tpu_torch.parallel.mesh_runtime import (
                            MeshSessionWindowOperator)
                        return MeshSessionWindowOperator(_a, _agg, mesh=_m,
                                                         **kwargs)
                    return SessionWindowOperator(_a, _agg, **kwargs)

                t = keyed._then("sql-session-agg", factory, chainable=False)
                return DataStream(keyed.env, t)
            return keyed.window(
                EventTimeSessionWindows(window.size_ms)).aggregate(
                    tuple_agg, value_selector=select_values,
                    name="sql-session-agg")
        if window.kind == "TUMBLE":
            assigner = TumblingEventTimeWindows.of(window.size_ms,
                                                   window.offset_ms)
        else:
            assigner = SlidingEventTimeWindows.of(window.size_ms,
                                                  window.slide_ms)
        return keyed.window(assigner).aggregate(
            tuple_agg, value_selector=select_values, name="sql-window-agg")

    def _merge_branches(self, a, b, key_col: str, emit_bounds: bool,
                        extra: List[str]):
        """Re-join the fired rows of two aggregate branches on the merge key
        (group key [+ window bounds]); ``extra`` = columns only branch b
        contributes."""
        from flink_tpu_torch.datastream.api import DataStream
        from flink_tpu_torch.graph.transformations import (Partitioning,
                                                           Transformation)
        from flink_tpu_torch.operators.sql_ops import BranchMergeOperator

        merge_hasher = (_CompositeKeyHasher()
                        if self.hash_composite_keys else None)

        def add_merge_key(cols, _kc=key_col, _b=emit_bounds,
                          _h=merge_hasher):
            n = _n(cols)
            out = dict(cols)
            parts = [np.asarray(cols[_kc])]
            if _b:
                parts += [np.asarray(cols["window_start"]),
                          np.asarray(cols["window_end"])]
            # same int64 hash-combine fast path as pre_project's __key —
            # BOTH branches share one hasher, so the collision check spans
            # the join (equal hashes with unequal components cannot merge)
            merge = _h.combine(parts, n) if _h is not None else None
            if merge is None:
                merge = np.fromiter(
                    (tuple(row) for row in zip(*(p.tolist() for p in parts))),
                    object, count=n)
            out["__merge"] = merge
            return out

        a = a.map(add_merge_key, name="sql-merge-key")
        b = b.map(add_merge_key, name="sql-merge-key")
        t = Transformation(
            name="sql-branch-merge",
            operator_factory=(lambda _x=tuple(extra):
                              BranchMergeOperator("__merge", list(_x))),
            inputs=[a.transformation, b.transformation],
            input_partitionings=[Partitioning.HASH, Partitioning.HASH],
            input_key_columns=["__merge", "__merge"],
            parallelism=self.env.parallelism, chainable=False,
            max_parallelism=self.env.max_parallelism)
        return DataStream(a.env, t)

    def _post_aggregate(self, agg_stream, items, having,
                        agg_specs: List[AggSpec], key_exprs: List[Expr],
                        single_col_key: bool, key_col: str,
                        emit_bounds: bool, stmt: SelectStmt,
                        orig_items: Optional[List[SelectItem]]) -> QueryPlan:
        # ---- split composite key back into its columns
        if not single_col_key and len(key_exprs) > 1:
            key_out_names = [f"__k{i}" for i in range(len(key_exprs))]
            hasher = getattr(self, "_key_hasher", None)

            def split_key(cols, _names=key_out_names, _h=hasher):
                out = dict(cols)
                tuples = np.asarray(cols["__key"])
                if _h is not None and tuples.dtype.kind in "iu":
                    # hashed fast path: recover the component columns from
                    # the shared side table (one sorted gather per part)
                    for nm, arr in zip(_names, _h.components(tuples)):
                        out[nm] = arr
                    return out
                for i, nm in enumerate(_names):
                    out[nm] = np.asarray([t[i] for t in tuples])
                return out

            agg_stream = agg_stream.map(split_key, name="sql-key-split")
            key_mapping = {k: Column(nm)
                           for k, nm in zip(key_exprs, key_out_names)}
        elif not single_col_key and len(key_exprs) == 1:
            key_mapping = {key_exprs[0]: Column("__key")}
        else:
            key_mapping = {}

        # ---- resolve select/having over the fired-batch schema
        aux_mapping: Dict[Expr, Expr] = dict(key_mapping)
        post_items = [SelectItem(_walk_replace(it.expr, aux_mapping), it.alias)
                      for it in items]
        # output names come from the user-visible items (aliases / original
        # column names like "sum_v"), not the internal __k/__agg rewrites
        names = _output_names(orig_items if orig_items is not None else items)
        # fired-batch schema: group keys + aggregate results (+ window
        # bounds) — referencing any other column is the classic "column must
        # appear in GROUP BY" SQL error, caught at plan time
        fired_schema = {s.out_name: None for s in agg_specs}
        if emit_bounds:
            fired_schema.update(window_start=None, window_end=None)
        if single_col_key:
            fired_schema[key_col] = None
        elif len(key_exprs) > 1:
            fired_schema.update({f"__k{i}": None
                                 for i in range(len(key_exprs))})
        else:
            fired_schema["__key"] = None
        post_compiler = ExprCompiler(fired_schema)

        if having is not None:
            hv = post_compiler.compile(_walk_replace(having, aux_mapping))
            agg_stream = agg_stream.filter(
                lambda cols, _p=hv: np.asarray(to_column(_p(cols), _n(cols)),
                                               bool), name="sql-having")

        fns = [post_compiler.compile(it.expr) for it in post_items]

        def project(cols, _fns=fns, _names=names):
            n = _n(cols)
            return {nm: to_column(f(cols), n) for nm, f in zip(_names, _fns)}

        out = agg_stream.map(project, name="sql-project")
        return QueryPlan(out, names, _order_names(stmt, items, names),
                         stmt.limit)


def _n(cols) -> int:
    for v in cols.values():
        return int(np.shape(v)[0])
    return 0


def _make_measure_fn(names: List[str], exprs: List[Expr],
                     var_names: List[str], part: Optional[str]):
    """MEASURES evaluator: one output row per match.  Scalar semantics of
    ``StreamExecMatch``'s generated condition/measure functions: a bare
    ``A.col`` is the LAST row mapped to A (ONE ROW PER MATCH),
    ``FIRST/LAST(A.col)`` navigate within A, aggregates fold over A's rows
    (or over the whole match when unqualified)."""
    uvars = [v.upper() for v in var_names]

    def rows_of(match, var):
        return match.get(var.upper(), [])

    def all_rows(match):
        out = []
        for v in uvars:
            out.extend(match.get(v, []))
        return out

    def last_row_value(match, name):
        for v in reversed(uvars):
            rows = match.get(v)
            if rows:
                return rows[-1].get(name)
        return None

    def agg(fn_name, vals):
        vals = [v for v in vals if v is not None]
        if fn_name == "COUNT":
            return len(vals)
        if not vals:
            return None
        if fn_name == "SUM":
            return sum(vals)
        if fn_name == "MIN":
            return min(vals)
        if fn_name == "MAX":
            return max(vals)
        if fn_name == "AVG":
            return sum(vals) / len(vals)
        raise PlanError(f"unsupported MEASURES aggregate {fn_name}")

    def ev(e: Expr, match):
        if isinstance(e, Literal):
            return e.value
        if isinstance(e, Interval):
            return e.ms
        if isinstance(e, Column):
            if e.table is not None:
                if e.table.upper() not in uvars:
                    raise PlanError(f"{e.table}.{e.name}: unknown pattern "
                                    f"variable in MEASURES")
                rows = rows_of(match, e.table)
                return rows[-1].get(e.name) if rows else None
            if part is not None and e.name == part:
                return all_rows(match)[0].get(part)
            return last_row_value(match, e.name)
        if isinstance(e, Call):
            nm = e.name
            if nm in ("FIRST", "LAST"):
                if len(e.args) != 1 or not isinstance(e.args[0], Column) \
                        or e.args[0].table is None:
                    raise PlanError(f"{nm} takes a variable-qualified "
                                    f"column (A.col)")
                rows = rows_of(match, e.args[0].table)
                if not rows:
                    return None
                row = rows[0] if nm == "FIRST" else rows[-1]
                return row.get(e.args[0].name)
            if nm in ("SUM", "COUNT", "MIN", "MAX", "AVG"):
                if len(e.args) == 1 and isinstance(e.args[0], Star):
                    return len(all_rows(match))
                if len(e.args) != 1 or not isinstance(e.args[0], Column):
                    raise PlanError(f"MEASURES {nm} takes one column")
                col = e.args[0]
                rows = (rows_of(match, col.table)
                        if col.table is not None else all_rows(match))
                return agg(nm, [r.get(col.name) for r in rows])
            raise PlanError(f"unsupported function {nm} in MEASURES")
        if isinstance(e, Unary):
            v = ev(e.operand, match)
            if e.op == "-":
                return None if v is None else -v
            return None if v is None else (not v)
        if isinstance(e, Binary):
            l, r = ev(e.left, match), ev(e.right, match)
            if e.op in ("AND", "OR"):
                return (l and r) if e.op == "AND" else (l or r)
            if l is None or r is None:
                return None
            return {"+": lambda: l + r, "-": lambda: l - r,
                    "*": lambda: l * r, "/": lambda: l / r,
                    "%": lambda: l % r, "||": lambda: str(l) + str(r),
                    "=": lambda: l == r, "<>": lambda: l != r,
                    "<": lambda: l < r, "<=": lambda: l <= r,
                    ">": lambda: l > r, ">=": lambda: l >= r}[e.op]()
        raise PlanError(f"unsupported MEASURES expression {e!r}")

    def select(match):
        row = {}
        if part is not None:
            row[part] = all_rows(match)[0].get(part)
        for nm, e in zip(names, exprs):
            row[nm] = ev(e, match)
        return row

    return select


def _output_names(items: List[SelectItem]) -> List[str]:
    names: List[str] = []
    for i, it in enumerate(items):
        nm = it.alias or expr_name(it.expr, i)
        base, k = nm, 0
        while nm in names:
            k += 1
            nm = f"{base}_{k}"
        names.append(nm)
    return names


def _order_names(stmt: SelectStmt, items: List[SelectItem],
                 names: List[str]) -> List[Tuple[str, bool]]:
    """Resolve ORDER BY entries to output column names (by alias, by matching
    select expression, or by 1-based ordinal)."""
    out: List[Tuple[str, bool]] = []
    for e, asc in stmt.order_by:
        if isinstance(e, Literal) and isinstance(e.value, int):
            out.append((names[e.value - 1], asc))
            continue
        if isinstance(e, Column):
            if e.name in names:
                out.append((e.name, asc))
                continue
        matched = None
        for it, nm in zip(items, names):
            if it.expr == e:
                matched = nm
                break
        if matched is None:
            raise PlanError(f"ORDER BY expression must appear in SELECT: {e}")
        out.append((matched, asc))
    return out

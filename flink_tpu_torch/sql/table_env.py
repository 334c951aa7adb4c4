"""TableEnvironment / Table / TableResult — the SQL entry points.

Analog of ``TableEnvironmentImpl.java:179`` (``executeSql:748``) and the
``Table`` API (``flink-table-api-java``): register tables over sources or
DataStreams, plan SQL through ``Planner`` onto the streaming runtime, collect
bounded results.  Each ``execute`` plans onto a FRESH
``StreamExecutionEnvironment`` so queries are isolated jobs (one job per
submission, like the reference's per-statement pipeline translation).

``TableEnvironment(device=...)`` is where the queries' device operators run
(window and group aggregates, the changelog aggregate, MATCH_RECOGNIZE's
CEP operator, the joins' device lane): ``None`` is the card and raises
without one, so a query on the CPU asks for ``device="cpu"``.  Every
environment it plans onto, the views' dry runs included, gets that device.
The Kafka and Postgres connectors come with a later slice: their DDL
raises ``NotImplementedError`` (``connectors.LATER``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

from flink_tpu_torch import DeviceLike, resolve_device
from flink_tpu_torch.connectors import later_connector
from flink_tpu_torch.sql.parser import SelectStmt, parse
from flink_tpu_torch.sql.planner import Planner, PlanError, QueryPlan


@dataclass
class CatalogTable:
    """A registered table: stream factory + schema + time attributes."""

    name: str
    columns: List[str]
    stream_factory: Callable[[Any], Any]   # env -> DataStream
    rowtime: Optional[str] = None
    watermark_delay_ms: int = 0
    timestamps_assigned: bool = False
    #: False = unbounded stream (a Kafka topic, a socket): joins over it
    #: must use incremental streaming operators, never wait-for-end-of-input
    bounded: bool = True
    #: True = rows are a CHANGELOG (``op`` column carries +I/-U/+U/-D):
    #: consumers must fold retractions, and aggregates/ORDER BY over the raw
    #: rows are rejected (a -U row is not data)
    changelog: bool = False
    #: lookup (dimension) table: ``lookup(key) -> list[dict]`` probes an
    #: external system; usable only via ``JOIN t FOR SYSTEM_TIME AS OF``
    lookup: Any = None
    lookup_cache_ttl_ms: int = 60_000
    #: the dimension's key column — the join condition must equal-match it
    lookup_key: Optional[str] = None
    _bound_env: Any = None
    #: lazy catalog statistics (row count + NDV) feeding the cost-based
    #: join reorder (sql/cost.py); computed on FIRST use — registration
    #: must not pay per-column np.unique for tables never joined.
    #: None factory = unknown stats, keeps syntactic plans
    stats_factory: Any = None
    stats: Any = None

    def get_stats(self):
        if self.stats is None and self.stats_factory is not None:
            self.stats = self.stats_factory()
        return self.stats

    def stream(self):
        return self.stream_factory(self._bound_env)


class TableEnvironment:
    """Catalog + SQL planner over the streaming runtime.  ``device``: where
    the queries' device operators run (None: the card, raising without
    one)."""

    def __init__(self, parallelism: int = 1, max_parallelism: int = 128,
                 mini_batch_rows: int = 0,
                 catalog_dir: Optional[str] = None,
                 hash_composite_keys: bool = True,
                 cep_vectorized: str = "auto",
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.parallelism = parallelism
        self.max_parallelism = max_parallelism
        #: >0 enables mini-batch bundling before group aggregates
        #: (``table.exec.mini-batch`` analog)
        self.mini_batch_rows = mini_batch_rows
        #: composite GROUP BY / merge keys ride the int64 hash-combine
        #: fast path (collision-checked side table) instead of per-row
        #: Python tuples; disable for multi-process SQL deployments where
        #: the pre-project and key-split maps land in different workers
        self.hash_composite_keys = hash_composite_keys
        #: MATCH_RECOGNIZE CepOperator engine mode (auto|on|off)
        self.cep_vectorized = cep_vectorized
        self._catalog: Dict[str, CatalogTable] = {}
        #: sink tables for INSERT INTO: name -> _SinkSpec
        self._sinks: Dict[str, "_SinkSpec"] = {}
        #: DDL-declared schemas, for DESCRIBE: name -> [(col, type), ...]
        self._ddl_types: Dict[str, List[Tuple[str, str]]] = {}
        #: names registered as VIEWs (DROP must match the object kind)
        self._views: set = set()
        #: durable catalog (``GenericInMemoryCatalog`` → persisted analog):
        #: every successful DDL appends to <dir>/catalog.json and replays on
        #: construction, so a catalog survives process restarts.  Point it
        #: at an object-store-backed mount for cluster-shared durability.
        self.catalog_dir = catalog_dir
        if catalog_dir:
            self._replay_catalog()

    @staticmethod
    def create(**kw) -> "TableEnvironment":
        return TableEnvironment(**kw)

    # ------------------------------------------------------- durable catalog
    def _catalog_file(self) -> str:
        import os
        return os.path.join(self.catalog_dir, "catalog.json")

    def _replay_catalog(self) -> None:
        import json
        import os
        os.makedirs(self.catalog_dir, exist_ok=True)
        path = self._catalog_file()
        if not os.path.exists(path):
            return
        with open(path) as f:
            for ddl in json.load(f):
                self._execute_ddl(ddl, persist=False)

    def _persist_ddl(self, sql: str) -> None:
        if not self.catalog_dir:
            return
        import json
        import os
        path = self._catalog_file()
        entries = []
        if os.path.exists(path):
            with open(path) as f:
                entries = json.load(f)
        entries.append(sql)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(entries, f, indent=1)
        os.replace(tmp, path)

    # ---------------------------------------------------------- registration
    def register_collection(self, name: str,
                            rows: Optional[Sequence[Mapping[str, Any]]] = None,
                            columns: Optional[Mapping[str, Any]] = None,
                            rowtime: Optional[str] = None,
                            watermark_delay_ms: int = 0,
                            batch_size: int = 4096,
                            bounded: bool = True) -> "Table":
        """Register an in-memory table (``fromValues`` analog).
        ``bounded=False`` declares it a stand-in for an unbounded stream:
        queries over it plan with incremental streaming operators (e.g. the
        changelog-emitting streaming join) instead of end-of-input ones."""
        if columns is not None:
            col_names = list(columns)
            data = {k: np.asarray(v) for k, v in columns.items()}
        elif rows:
            col_names = list(rows[0].keys())
            data = {k: np.asarray([r[k] for r in rows]) for k in col_names}
        else:
            raise ValueError("rows or columns required")

        def factory(env, _data=data, _bs=batch_size):
            return env.from_collection(columns=_data, batch_size=_bs,
                                       name=f"table:{name}")

        def make_stats(_data=data):
            from flink_tpu_torch.sql.cost import TableStats
            return TableStats.from_columns(_data)

        ct = CatalogTable(name, col_names, factory, rowtime=rowtime,
                          watermark_delay_ms=watermark_delay_ms,
                          stats_factory=make_stats, bounded=bounded)
        self._catalog[name] = ct
        return Table(self, SelectStmt(items=[], table=name), ct)

    def register_source(self, name: str, source, columns: List[str],
                        rowtime: Optional[str] = None,
                        watermark_delay_ms: int = 0,
                        bounded: bool = True) -> "Table":
        """Register any connector ``Source`` as a table."""
        def factory(env, _src=source):
            return env.from_source(_src, name=f"table:{name}")

        ct = CatalogTable(name, list(columns), factory, rowtime=rowtime,
                          watermark_delay_ms=watermark_delay_ms,
                          bounded=bounded)
        self._catalog[name] = ct
        return Table(self, SelectStmt(items=[], table=name), ct)

    def register_lookup_table(self, name: str, lookup_fn,
                              columns: List[str],
                              key_column: Optional[str] = None,
                              cache_ttl_ms: int = 60_000) -> None:
        """Register a DIMENSION table backed by an external point-lookup
        (``lookup_fn(key) -> list[dict]``, e.g. a Postgres primary-key
        query).  Only joinable via ``JOIN name FOR SYSTEM_TIME AS OF
        o.proctime`` — the ``StreamExecLookupJoin`` shape; results are
        cached per key for ``cache_ttl_ms``."""
        def no_scan(env):
            raise PlanError(f"lookup table {name!r} cannot be scanned; use "
                            f"JOIN {name} FOR SYSTEM_TIME AS OF ...")

        self._catalog[name] = CatalogTable(
            name, list(columns), no_scan, lookup=lookup_fn,
            lookup_cache_ttl_ms=cache_ttl_ms, lookup_key=key_column)

    def create_temporary_view(self, name: str, table: "Table") -> None:
        """Register a planned query as a view (``createTemporaryView``)."""
        stmt = table._stmt

        def factory(env, _stmt=stmt):
            plan = Planner(env, self._catalog,
                           hash_composite_keys=self.hash_composite_keys,
                           cep_vectorized=self.cep_vectorized).plan(_stmt)
            return plan.stream

        cols, changelog, unbounded = self._view_traits(stmt)
        # timestamps_assigned stays False: a windowed query OVER the view
        # names its own time column, and re-assigning watermarks from it is
        # always safe on bounded inputs (the view's own event-time handling,
        # if any, already happened inside its plan)
        self._catalog[name] = CatalogTable(name, cols, factory,
                                           bounded=not unbounded,
                                           changelog=changelog)
        self._views.add(name)

    def _view_traits(self, stmt: SelectStmt):
        """Dry-plan on a throwaway env to learn a view's output schema and
        whether its rows are an (unbounded) changelog — unboundedness must
        survive the view boundary or joins over it plan end-of-input."""
        from flink_tpu_torch.datastream.api import StreamExecutionEnvironment
        env = StreamExecutionEnvironment(parallelism=self.parallelism,
                                         max_parallelism=self.max_parallelism,
                                         device=self.device)
        for t in self._catalog.values():
            t._bound_env = env
        planner = Planner(env, self._catalog,
                          hash_composite_keys=self.hash_composite_keys,
                          cep_vectorized=self.cep_vectorized)
        try:
            cols = planner.plan(stmt).output_columns
            return cols, planner._changelog_join, planner._unbounded_plan
        finally:
            for t in self._catalog.values():
                t._bound_env = None

    def _output_columns(self, stmt: SelectStmt) -> List[str]:
        return self._view_traits(stmt)[0]

    # ---------------------------------------------------------------- query
    def register_sink_table(self, name: str, path: str,
                            fmt: Optional[str] = None) -> None:
        """Register a file-backed sink table — the `INSERT INTO` target
        (``CREATE TABLE ... WITH ('connector'='filesystem')`` analog).
        ``fmt`` defaults to the path's extension (csv/jsonl/ftb/avro)."""
        from flink_tpu_torch.formats import writer_for
        resolved = fmt or path.rsplit(".", 1)[-1]
        writer_for(resolved)   # validate NOW — fail at registration, not
        #                        after the INSERT's query already ran
        self._sinks[name] = _FileSinkSpec(path, resolved)

    def sql_query(self, sql: str) -> "Table":
        return Table(self, parse(sql))

    def execute_sql(self, sql: str) -> "TableResult":
        """SELECT / UNION chains, ``INSERT INTO sink SELECT ...``,
        ``EXPLAIN <query>``, and DDL — CREATE TABLE ... WITH (connector
        properties), CREATE VIEW, DROP, SHOW TABLES, DESCRIBE
        (``TableEnvironmentImpl.executeSql:748`` dispatching DDL like
        ``TableEnvironmentImpl.java:197-205``)."""
        stripped = sql.strip()
        up = stripped.upper()
        first = up.split(None, 1)[0] if up else ""
        if first in ("CREATE", "DROP", "SHOW", "DESCRIBE", "DESC"):
            return self._execute_ddl(stripped)
        if first == "EXPLAIN":
            return _ExplainResult(self.explain_sql(stripped[len("EXPLAIN"):]))
        if first == "INSERT":
            return self._execute_insert(stripped)
        return self.sql_query(sql).execute()

    # ------------------------------------------------------------------ DDL
    def _execute_ddl(self, sql: str, persist: bool = True):
        from flink_tpu_torch.sql.parser import (CreateTableStmt,
                                                CreateViewStmt, DescribeStmt,
                                                DropStmt, ShowTablesStmt,
                                                parse_any)
        stmt = parse_any(sql)
        if isinstance(stmt, CreateTableStmt):
            if stmt.name in self._catalog or stmt.name in self._sinks:
                if stmt.if_not_exists:
                    return _DdlResult("OK")
                raise PlanError(f"table {stmt.name!r} already exists")
            self._register_connector_table(stmt)
            if persist:
                self._persist_ddl(sql)
            return _DdlResult("OK")
        if isinstance(stmt, CreateViewStmt):
            if stmt.name in self._catalog:
                if stmt.if_not_exists:
                    return _DdlResult("OK")
                raise PlanError(f"view {stmt.name!r} already exists")
            query = stmt.query

            def factory(env, _q=query):
                return Planner(env, self._catalog).plan(_q).stream

            cols, changelog, unbounded = self._view_traits(query)
            self._catalog[stmt.name] = CatalogTable(
                stmt.name, cols, factory, bounded=not unbounded,
                changelog=changelog)
            self._views.add(stmt.name)
            if persist:
                self._persist_ddl(sql)
            return _DdlResult("OK")
        if isinstance(stmt, DropStmt):
            known = stmt.name in self._catalog or stmt.name in self._sinks
            if not known and not stmt.if_exists:
                raise PlanError(f"{stmt.kind.lower()} {stmt.name!r} does "
                                f"not exist")
            if known:
                is_view = stmt.name in self._views
                if stmt.kind == "VIEW" and not is_view:
                    raise PlanError(f"{stmt.name!r} is a table, not a "
                                    f"view (use DROP TABLE)")
                if stmt.kind == "TABLE" and is_view:
                    raise PlanError(f"{stmt.name!r} is a view, not a "
                                    f"table (use DROP VIEW)")
            self._catalog.pop(stmt.name, None)
            self._sinks.pop(stmt.name, None)
            self._ddl_types.pop(stmt.name, None)
            self._views.discard(stmt.name)
            if persist and known:
                self._persist_ddl(sql)
            return _DdlResult("OK")
        if isinstance(stmt, ShowTablesStmt):
            names = sorted(set(self._catalog) | set(self._sinks))
            return _RowsResult([{"table name": n} for n in names],
                               ["table name"])
        if isinstance(stmt, DescribeStmt):
            if stmt.name in self._ddl_types:
                rows = [{"name": c, "type": t}
                        for c, t in self._ddl_types[stmt.name]]
            elif stmt.name in self._catalog:
                rows = [{"name": c, "type": "ANY"}
                        for c in self._catalog[stmt.name].columns]
            else:
                raise PlanError(f"table {stmt.name!r} does not exist")
            return _RowsResult(rows, ["name", "type"])
        raise PlanError(f"unsupported DDL {type(stmt).__name__}")

    def _register_connector_table(self, stmt) -> None:
        """CREATE TABLE → connector registration (source and, where the
        connector writes, the INSERT INTO sink)."""
        props = stmt.properties
        conn = props.get("connector")
        if conn is None:
            raise PlanError("CREATE TABLE requires a 'connector' property")
        cols = [c.name for c in stmt.columns]
        name = stmt.name
        rowtime = stmt.watermark_column
        delay = stmt.watermark_delay_ms
        self._ddl_types[name] = [(c.name, c.type_name) for c in stmt.columns]

        if conn == "filesystem":
            path = props.get("path")
            if not path:
                raise PlanError("filesystem connector requires 'path'")
            fmt = props.get("format") or path.rsplit(".", 1)[-1]
            from flink_tpu_torch.formats import writer_for
            writer_for(fmt)                      # validate format name

            def factory(env, _p=path, _f=fmt, _rt=rowtime):
                from flink_tpu_torch.connectors.file_source import FileSource
                return env.from_source(
                    FileSource(_p, _f, timestamp_column=_rt),
                    name=f"table:{name}")

            self._catalog[name] = CatalogTable(
                name, cols, factory, rowtime=rowtime,
                watermark_delay_ms=delay)
            self._sinks[name] = _FileSinkSpec(path, fmt)
            return
        if conn in ("kafka", "postgres", "jdbc"):
            raise later_connector("postgres" if conn == "jdbc" else conn)
        raise PlanError(f"unknown connector {conn!r} (have: filesystem, "
                        f"kafka, postgres)")

    def explain_sql(self, sql: str) -> str:
        """Textual physical plan: the vertex/edge list of the stream graph
        the query lowers to (``explainSql`` analog)."""
        env, plan, planner = self._plan(parse(sql), return_planner=True)
        plan.stream.collect()   # graph building needs a sink-reachable DAG
        g = env.get_stream_graph("explain")
        ep = g.to_plan()
        lines = []
        if planner.applied_rules:
            seen = dict.fromkeys(planner.applied_rules)  # ordered dedup
            lines.append("== Logical Rewrites Applied ==")
            lines.extend(f"  {r}" for r in seen)
        note = getattr(planner, "cost_note", None)
        if note is not None:
            lines.append("== Join Order (cost-based) ==")
            lines.append(f"  {note}")
        lines.append("== Physical Execution Plan ==")
        for v in ep.vertices:
            chain = " -> ".join(getattr(n, "name", "?") for n in v.chain) \
                or v.name
            lines.append(f"Vertex {v.id}: {v.name} (parallelism "
                         f"{v.parallelism}) [{chain}]")
            for e in v.out_edges:
                tgt = ep.by_id[e.target_id]
                lines.append(f"  -> {tgt.name} [{e.partitioning}]")
        lines.append(f"Output columns: {plan.output_columns}")
        return "\n".join(lines)

    def _execute_insert(self, sql: str) -> "_InsertResult":
        import re as _re

        m = _re.match(r"(?is)^INSERT\s+INTO\s+([A-Za-z_][A-Za-z_0-9]*)\s+"
                      r"(SELECT.*)$", sql)
        if not m:
            raise PlanError("INSERT syntax: INSERT INTO <sink_table> "
                            "SELECT ...")
        sink_name, query = m.group(1), m.group(2)
        if sink_name not in self._sinks:
            raise PlanError(f"unknown sink table {sink_name!r}; register it "
                            f"with register_sink_table(name, path) or "
                            f"CREATE TABLE ... WITH (...)")
        spec = self._sinks[sink_name]
        result = self.sql_query(query).execute()
        rows = result.collect()
        from flink_tpu_torch.core.batch import RecordBatch
        batch = RecordBatch.from_rows(rows) if rows else RecordBatch({})
        n, target = spec.write([batch])
        return _InsertResult(n, target)

    def _plan(self, stmt: SelectStmt, return_planner: bool = False):
        from flink_tpu_torch.datastream.api import StreamExecutionEnvironment
        env = StreamExecutionEnvironment(parallelism=self.parallelism,
                                         max_parallelism=self.max_parallelism,
                                         device=self.device)
        for t in self._catalog.values():
            t._bound_env = env
        planner = Planner(env, self._catalog,
                          mini_batch_rows=self.mini_batch_rows,
                          hash_composite_keys=self.hash_composite_keys,
                          cep_vectorized=self.cep_vectorized)
        try:
            plan = planner.plan(stmt)
        finally:
            for t in self._catalog.values():
                t._bound_env = None
        plan.changelog = planner._changelog_join
        if return_planner:
            return env, plan, planner
        return env, plan


class Table:
    """A (lazily planned) relational query (``Table`` analog)."""

    def __init__(self, tenv: TableEnvironment, stmt: SelectStmt,
                 catalog_entry: Optional[CatalogTable] = None):
        self.tenv = tenv
        self._stmt = stmt
        self._entry = catalog_entry

    # -- fluent Table API (sugar over the SQL AST) --------------------------
    def _table_name(self) -> str:
        from flink_tpu_torch.sql.parser import UnionStmt
        if isinstance(self._stmt, UnionStmt):
            raise PlanError("fluent Table transformations are not supported "
                            "on UNION queries; use execute_sql")
        if self._stmt.table is None:
            raise PlanError("table has no FROM target")
        return self._stmt.table

    def select(self, select_list: str) -> "Table":
        """Replace the projection, keeping WHERE/GROUP BY/... intact."""
        import copy
        items = parse(f"SELECT {select_list} FROM {self._table_name()}").items
        stmt = copy.copy(self._stmt)
        stmt.items = items
        return Table(self.tenv, stmt)

    def where(self, condition: str) -> "Table":
        """AND the condition into the existing WHERE clause."""
        import copy
        from flink_tpu_torch.sql.parser import Binary
        cond = parse(
            f"SELECT * FROM {self._table_name()} WHERE {condition}").where
        stmt = copy.copy(self._stmt)
        stmt.where = (cond if stmt.where is None
                      else Binary("AND", stmt.where, cond))
        return Table(self.tenv, stmt)

    filter = where

    def group_by(self, keys: str) -> "GroupedTable":
        return GroupedTable(self, keys)

    # -- execution ----------------------------------------------------------
    def execute(self) -> "TableResult":
        import copy
        stmt = self._stmt
        if getattr(stmt, "items", None) is not None and not stmt.items:
            # bare registered table: SELECT *
            stmt = copy.copy(stmt)
            stmt.items = parse(f"SELECT * FROM {stmt.table}").items
        env, plan = self.tenv._plan(stmt)
        return TableResult(env, plan)

    def to_data_stream(self, env=None):
        """Plan onto ``env`` (or the table env's fresh one) and return the
        result ``DataStream`` (``toDataStream`` / ``toChangelogStream``)."""
        import copy
        stmt = self._stmt
        if getattr(stmt, "items", None) is not None and not stmt.items:
            stmt = copy.copy(stmt)
            stmt.items = parse(f"SELECT * FROM {stmt.table}").items
        if env is None:
            env, plan = self.tenv._plan(stmt)
            return plan.stream
        for t in self.tenv._catalog.values():
            t._bound_env = env
        try:
            return Planner(env, self.tenv._catalog).plan(stmt).stream
        finally:
            for t in self.tenv._catalog.values():
                t._bound_env = None


    # -- blink-runtime extensions ------------------------------------------
    def _planned(self):
        import copy
        stmt = self._stmt
        if getattr(stmt, "items", None) is not None and not stmt.items:
            # bare table: fill in SELECT * but KEEP where()/group-by state
            stmt = copy.copy(stmt)
            stmt.items = parse(f"SELECT * FROM {stmt.table}").items
        return self.tenv._plan(stmt)

    @staticmethod
    def _keyed_then(stream, key_column: Optional[str], name: str, factory):
        """Route to the stateful operator by key (or send EVERYTHING to one
        subtask when unpartitioned) — per-key state is only correct when
        every row of a key meets the same operator instance."""
        from flink_tpu_torch.datastream.api import DataStream
        from flink_tpu_torch.graph.transformations import Partitioning

        if key_column is not None:
            keyed = stream.key_by(key_column)
            return DataStream(keyed.env, keyed._then(name, factory,
                                                     chainable=False))
        t = stream._then(name, factory, partitioning=Partitioning.GLOBAL,
                         chainable=False)
        return DataStream(stream.env, t)

    def top_n(self, n: int, partition_by: Optional[str],
              order_by: str, ascending: bool = False) -> "TableResult":
        """Top-N per partition (``StreamExecRank`` analog): final ranked
        rows with a ``rank`` column."""
        from flink_tpu_torch.operators.sql_ops import TopNOperator

        env, plan = self._planned()
        out = Table._keyed_then(
            plan.stream, partition_by, "sql-top-n",
            lambda: TopNOperator(n, partition_by, order_by,
                                 ascending=ascending, emit_changelog=False))
        return TableResult(env, QueryPlan(out, plan.output_columns + ["rank"]))

    def deduplicate(self, key: str, keep: str = "first",
                    order_by: Optional[str] = None) -> "TableResult":
        """Deduplication per key (``Deduplicate`` exec node analog)."""
        from flink_tpu_torch.operators.sql_ops import DeduplicateOperator

        env, plan = self._planned()
        out = Table._keyed_then(
            plan.stream, key, "sql-deduplicate",
            lambda: DeduplicateOperator(key, keep=keep, order_column=order_by))
        return TableResult(env, QueryPlan(out, plan.output_columns))


class GroupedTable:
    def __init__(self, table: Table, keys: str):
        self.table = table
        self.keys = keys

    def select(self, select_list: str) -> Table:
        import copy
        sql = (f"SELECT {select_list} FROM {self.table._table_name()} "
               f"GROUP BY {self.keys}")
        stmt = parse(sql)
        stmt.where = copy.copy(self.table._stmt.where)  # keep prior where()
        return Table(self.table.tenv, stmt)

    def select_changelog(self, select_list: str) -> "TableResult":
        """Non-windowed group aggregate as a CHANGELOG stream with
        retraction rows (+I / -U / +U in the ``op`` column) — the
        ``GroupAggFunction`` retraction semantics of the blink runtime."""
        from flink_tpu_torch.datastream.api import DataStream
        from flink_tpu_torch.operators.sql_ops import ChangelogGroupAggOperator
        from flink_tpu_torch.sql.parser import Call, Column as PCol, Star
        from flink_tpu_torch.sql.planner import QueryPlan as QP

        if "," in self.keys:
            raise PlanError("select_changelog supports a single group key")
        key = self.keys.strip()
        items = parse(f"SELECT {select_list} "
                      f"FROM {self.table._table_name()}").items
        agg_columns = {}
        out_cols = ["op", key]
        for it in items:
            e = it.expr
            if isinstance(e, PCol) and e.name == key:
                continue
            if not (isinstance(e, Call) and e.name in
                    ("SUM", "COUNT", "MIN", "MAX")):
                raise PlanError("select_changelog items must be the key or "
                                "SUM/COUNT/MIN/MAX aggregates")
            if e.name == "COUNT":
                col = None
            else:
                if len(e.args) != 1 or not isinstance(e.args[0], PCol):
                    raise PlanError(f"{e.name} needs one plain column arg")
                col = e.args[0].name
            out = it.alias or f"{e.name.lower()}_{col or 'rows'}"
            agg_columns[out] = (col, e.name.lower()
                                if e.name != "COUNT" else "count")
            out_cols.append(out)

        env, plan = self.table._planned()
        # a changelog input (CDC table, streaming-join view) must FOLD
        # retractions, not sum raw rows; the plan carries the trait
        # explicitly — a user column merely NAMED 'op' stays plain data
        consume = plan.changelog
        out = Table._keyed_then(
            plan.stream, key, "sql-changelog-agg",
            lambda: ChangelogGroupAggOperator(
                key, agg_columns, consume_retractions=consume))
        return TableResult(env, QP(out, out_cols))


class _SinkSpec:
    """INSERT INTO target: writes batches, returns (rows, target desc)."""

    def write(self, batches) -> Tuple[int, str]:  # pragma: no cover
        raise NotImplementedError


class _FileSinkSpec(_SinkSpec):
    def __init__(self, path: str, fmt: str):
        self.path, self.fmt = path, fmt

    def write(self, batches):
        from flink_tpu_torch.formats import writer_for
        return writer_for(self.fmt)(batches, self.path), self.path


class _DdlResult:
    """Result of a DDL statement (``TableResultImpl.TABLE_RESULT_OK``)."""

    def __init__(self, status: str = "OK"):
        self.status = status

    def collect(self):
        return [{"result": self.status}]

    def print(self) -> None:
        print(self.status)


class _RowsResult:
    """Static rows (SHOW TABLES / DESCRIBE)."""

    def __init__(self, rows, columns):
        self._rows = rows
        self.output_columns = columns

    def collect(self):
        return self._rows

    def print(self) -> None:
        print(" | ".join(self.output_columns))
        for r in self._rows:
            print(" | ".join(str(r[c]) for c in self.output_columns))


class _ExplainResult:
    """Result of ``EXPLAIN <query>``: the plan text."""

    def __init__(self, text: str):
        self.text = text

    def collect(self):
        return [{"plan": self.text}]

    def print(self) -> None:
        print(self.text)


class _InsertResult:
    """Result of ``INSERT INTO``: rows written + target path."""

    def __init__(self, rows_written: int, path: str):
        self.rows_written = rows_written
        self.path = path

    def collect(self):
        return [{"rows_written": self.rows_written, "path": self.path}]

    def print(self) -> None:
        print(f"{self.rows_written} rows -> {self.path}")


class TableResult:
    """Bounded query result: executes the job on collect (``TableResult``)."""

    def __init__(self, env, plan: QueryPlan):
        self.env = env
        self.plan = plan
        self._rows: Optional[List[Dict[str, Any]]] = None

    @property
    def output_columns(self) -> List[str]:
        return self.plan.output_columns

    def collect(self) -> List[Dict[str, Any]]:
        if self._rows is None:
            sink = self.plan.stream.collect()
            self.env.execute("sql-query")
            rows = sink.rows()
            rows = [{k: r.get(k) for k in self.plan.output_columns}
                    for r in rows]
            if self.plan.order_by:
                keys = list(reversed(self.plan.order_by))

                def sort_key_chain(rs):
                    for name, asc in keys:
                        rs.sort(key=lambda r: r[name], reverse=not asc)
                    return rs
                rows = sort_key_chain(rows)
            if self.plan.limit is not None:
                rows = rows[: self.plan.limit]
            self._rows = rows
        return self._rows

    def print(self) -> None:
        rows = self.collect()
        cols = self.plan.output_columns
        print(" | ".join(cols))
        for r in rows:
            print(" | ".join(str(r[c]) for c in cols))

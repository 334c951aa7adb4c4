"""SQL & Table API layer.

Stack (reference analog in parens): ``parser.py`` — lexer/recursive-descent
parser (Calcite, ``flink-sql-parser``); ``expressions.py`` — columnar closure
compiler (Janino codegen, ``codegen/``); ``planner.py`` — SELECT → DataStream
lowering (Blink planner ``PlannerBase.scala:155`` →
``StreamExecGroupWindowAggregate.java:103``); ``table_env.py`` —
``TableEnvironment``/``Table``/``TableResult`` entry points
(``TableEnvironmentImpl.java:179``).
"""

from flink_tpu_torch.sql.expressions import ExprCompiler, PlanError
from flink_tpu_torch.sql.parser import SqlParseError, parse
from flink_tpu_torch.sql.planner import Planner, QueryPlan
from flink_tpu_torch.sql.table_env import (CatalogTable, Table,
                                           TableEnvironment, TableResult)

__all__ = [
    "CatalogTable", "ExprCompiler", "PlanError", "Planner", "QueryPlan",
    "SqlParseError", "Table", "TableEnvironment", "TableResult", "parse",
]

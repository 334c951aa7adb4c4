"""SQL lexer + AST + recursive-descent parser.

The reference parses SQL with Calcite (``flink-table/flink-sql-parser/``,
grammar templates) into ``SqlNode`` trees validated by the Blink planner
(``PlannerBase.scala:155``).  This is a self-contained parser for the
streaming-SQL dialect subset the framework executes: SELECT with expressions,
WHERE, GROUP BY (including the group-window functions ``TUMBLE``/``HOP``/
``SESSION`` of ``StreamExecGroupWindowAggregate.java:103``), HAVING,
ORDER BY / LIMIT (bounded results), aggregates, CASE, CAST, BETWEEN, IN,
LIKE, and INTERVAL/DATE/TIMESTAMP literals.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class SqlParseError(ValueError):
    pass


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

class Expr:
    __slots__ = ()


@dataclass(frozen=True)
class Literal(Expr):
    value: object  # int | float | str | bool | None


@dataclass(frozen=True)
class Column(Expr):
    name: str
    #: optional table/alias qualifier ("a.k" -> Column("k", table="a"))
    table: Optional[str] = None


@dataclass(frozen=True)
class Star(Expr):
    pass


@dataclass(frozen=True)
class Unary(Expr):
    op: str  # '-', 'NOT'
    operand: Expr


@dataclass(frozen=True)
class Binary(Expr):
    op: str  # + - * / % || = <> < <= > >= AND OR
    left: Expr
    right: Expr


@dataclass(frozen=True)
class Call(Expr):
    name: str  # uppercased
    args: Tuple[Expr, ...]
    distinct: bool = False


@dataclass(frozen=True)
class Cast(Expr):
    expr: Expr
    type_name: str


@dataclass(frozen=True)
class Case(Expr):
    whens: Tuple[Tuple[Expr, Expr], ...]
    default: Optional[Expr]


@dataclass(frozen=True)
class Between(Expr):
    expr: Expr
    lo: Expr
    hi: Expr
    negated: bool = False


@dataclass(frozen=True)
class InList(Expr):
    expr: Expr
    items: Tuple[Expr, ...]
    negated: bool = False


@dataclass(frozen=True)
class Like(Expr):
    expr: Expr
    pattern: str
    negated: bool = False


@dataclass(frozen=True)
class IsNull(Expr):
    expr: Expr
    negated: bool = False


@dataclass(frozen=True)
class Interval(Expr):
    """Time interval, normalized to milliseconds."""

    ms: int


@dataclass(frozen=True)
class OverCall(Expr):
    """Window function call: ``fn(args) OVER (PARTITION BY p ORDER BY o
    [DESC] [frame])`` — the ``StreamExecRank`` shape (ROW_NUMBER in a Top-N
    subquery) and the ``StreamExecOverAggregate`` shape (SUM/COUNT/AVG/MIN/
    MAX over a partition).  Frame: both bounds None = RANGE UNBOUNDED
    PRECEDING (the SQL default when ORDER BY is present); ``frame_rows`` =
    ROWS n PRECEDING AND CURRENT ROW; ``frame_range_ms`` = RANGE INTERVAL
    n PRECEDING AND CURRENT ROW."""

    func: str
    partition_by: Optional[Expr]
    order_by: Optional[Expr]
    ascending: bool = True
    args: Tuple[Expr, ...] = ()
    frame_rows: Optional[int] = None
    frame_range_ms: Optional[int] = None
    #: ROWS frames are per-row; RANGE frames include peer rows (same order
    #: value) — matters only for unbounded frames with duplicate timestamps
    frame_is_rows: bool = False
    distinct: bool = False


@dataclass
class UnionStmt:
    """``SELECT ... UNION [ALL] SELECT ...`` chain; trailing ORDER BY/LIMIT
    bind to the whole union (standard SQL)."""

    parts: List["SelectStmt"]
    alls: List[bool]                     # one per UNION keyword
    order_by: List[Tuple["Expr", bool]]
    limit: Optional[int] = None


@dataclass
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


@dataclass
class JoinClause:
    table: str
    alias: Optional[str]
    kind: str          # inner / left / right / full
    on: Expr
    #: set by the rewrite stage (rules.filter_pushdown): predicate applied
    #: to THIS input before the join (bare column names)
    pre_filter: Optional[Expr] = None
    #: ``JOIN t FOR SYSTEM_TIME AS OF <expr>``: temporal (versioned-table)
    #: or lookup (dimension) join — the time attribute of the LEFT row at
    #: which the right side is observed (``SqlSnapshot`` /
    #: ``StreamExecTemporalJoin`` / ``StreamExecLookupJoin``)
    system_time_of: Optional[Expr] = None


@dataclass
class MatchStage:
    """One PATTERN variable with its regex quantifier."""

    var: str
    quant_min: int = 1
    quant_max: Optional[int] = 1   # None = unbounded (+ / *)
    optional: bool = False         # ? or *


@dataclass
class MatchRecognizeClause:
    """``MATCH_RECOGNIZE (PARTITION BY .. ORDER BY .. MEASURES ..
    [ONE ROW PER MATCH] [AFTER MATCH SKIP ..] PATTERN (..)
    [WITHIN INTERVAL ..] DEFINE ..)`` — the row-pattern clause of
    ``SqlMatchRecognize`` (``flink-sql-parser``), lowered onto the CEP NFA
    (``StreamExecMatch.java:90``)."""

    partition_by: List[str]
    order_by: str
    measures: List[SelectItem]
    pattern: List[MatchStage]
    defines: dict                       # var -> Expr
    after_match: str = "skip_to_next"   # skip_to_next | skip_past_last
    within_ms: Optional[int] = None
    alias: Optional[str] = None


@dataclass
class SelectStmt:
    items: List[SelectItem]
    table: Optional[str]
    table_alias: Optional[str] = None
    #: FROM <table> MATCH_RECOGNIZE ( ... ): row-pattern recognition
    match: Optional["MatchRecognizeClause"] = None
    joins: List["JoinClause"] = field(default_factory=list)
    where: Optional[Expr] = None
    group_by: List[Expr] = field(default_factory=list)
    having: Optional[Expr] = None
    order_by: List[Tuple[Expr, bool]] = field(default_factory=list)  # (expr, asc)
    limit: Optional[int] = None
    #: rewrite-stage annotations (rules.py): predicate pushed onto the base
    #: scan, and the pruned column set the scan should project to
    scan_filter: Optional[Expr] = None
    scan_columns: Optional[Tuple[str, ...]] = None
    #: cost-stage annotation (cost.py join_reorder): chosen join order +
    #: estimated cost; also the done-marker so the rule runs once
    join_order_cost: Optional[str] = None


@dataclass
class ColumnDef:
    name: str
    type_name: str                      # normalized SQL type text


@dataclass
class CreateTableStmt:
    """``CREATE TABLE t (col TYPE, ..., [WATERMARK FOR c AS c - INTERVAL
    ...,] [PRIMARY KEY (c) NOT ENFORCED]) WITH ('connector'='...', ...)`` —
    the ``SqlCreateTable`` shape (``flink-sql-parser/.../ddl/
    SqlCreateTable.java``)."""

    name: str
    columns: List[ColumnDef]
    properties: dict                    # the WITH map, lower-cased keys
    watermark_column: Optional[str] = None
    watermark_delay_ms: int = 0
    primary_key: Optional[str] = None
    if_not_exists: bool = False


@dataclass
class CreateViewStmt:
    name: str
    query: object                       # SelectStmt | UnionStmt
    if_not_exists: bool = False


@dataclass
class DropStmt:
    kind: str                           # 'TABLE' | 'VIEW'
    name: str
    if_exists: bool = False


@dataclass
class ShowTablesStmt:
    pass


@dataclass
class DescribeStmt:
    name: str


#: aggregate function names the planner splits out of expressions
AGG_FUNCS = {"SUM", "COUNT", "AVG", "MIN", "MAX"}
#: group-window functions (GROUP BY position)
WINDOW_FUNCS = {"TUMBLE", "HOP", "SESSION"}
#: auxiliary window accessors (SELECT position)
WINDOW_AUX = {
    "TUMBLE_START", "TUMBLE_END", "TUMBLE_ROWTIME", "TUMBLE_PROCTIME",
    "HOP_START", "HOP_END", "HOP_ROWTIME",
    "SESSION_START", "SESSION_END", "SESSION_ROWTIME",
    "WINDOW_START", "WINDOW_END",
}

_UNIT_MS = {
    "MILLISECOND": 1, "MILLISECONDS": 1,
    "SECOND": 1000, "SECONDS": 1000,
    "MINUTE": 60_000, "MINUTES": 60_000,
    "HOUR": 3_600_000, "HOURS": 3_600_000,
    "DAY": 86_400_000, "DAYS": 86_400_000,
}

_KEYWORDS = {
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER", "ASC",
    "DESC", "LIMIT", "AS", "AND", "OR", "NOT", "IN", "BETWEEN", "LIKE",
    "IS", "NULL", "TRUE", "FALSE", "CASE", "WHEN", "THEN", "ELSE", "END",
    "CAST", "INTERVAL", "DATE", "TIMESTAMP", "DISTINCT",
    "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "OUTER", "ON",
    "OVER", "PARTITION", "UNION", "ALL",
}
# NOTE: the OVER frame words (ROWS/RANGE/PRECEDING/UNBOUNDED/CURRENT/ROW)
# are deliberately NOT keywords — they are non-reserved in standard SQL and
# are matched contextually inside OVER(...) (Parser.at_word), so they remain
# usable as column names.

_TOKEN_RE = re.compile(r"""
    \s+
  | --[^\n]*
  | (?P<number>\d+(\.\d*)?([eE][+-]?\d+)?|\.\d+)
  | (?P<string>'(?:[^']|'')*')
  | (?P<ident>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<qident>"[^"]+"|`[^`]+`)
  | (?P<op><>|!=|<=|>=|\|\||[-+*/%(),.<>=?{}])
""", re.VERBOSE)


@dataclass(frozen=True)
class Token:
    kind: str   # NUMBER STRING IDENT KEYWORD OP EOF
    value: str
    pos: int


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    pos = 0
    n = len(sql)
    while pos < n:
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SqlParseError(f"unexpected character {sql[pos]!r} at {pos}")
        if m.lastgroup == "number":
            out.append(Token("NUMBER", m.group("number"), pos))
        elif m.lastgroup == "string":
            raw = m.group("string")[1:-1].replace("''", "'")
            out.append(Token("STRING", raw, pos))
        elif m.lastgroup == "ident":
            text = m.group("ident")
            up = text.upper()
            out.append(Token("KEYWORD" if up in _KEYWORDS else "IDENT",
                             up if up in _KEYWORDS else text, pos))
        elif m.lastgroup == "qident":
            out.append(Token("IDENT", m.group("qident")[1:-1], pos))
        elif m.lastgroup == "op":
            out.append(Token("OP", m.group("op"), pos))
        pos = m.end()
    out.append(Token("EOF", "", pos))
    return out


class Parser:
    def __init__(self, sql: str):
        self.tokens = tokenize(sql)
        self.i = 0

    # -- token helpers ------------------------------------------------------
    def peek(self) -> Token:
        return self.tokens[self.i]

    def next(self) -> Token:
        t = self.tokens[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, value: Optional[str] = None) -> Optional[Token]:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            return self.next()
        return None

    def expect(self, kind: str, value: Optional[str] = None) -> Token:
        t = self.accept(kind, value)
        if t is None:
            got = self.peek()
            raise SqlParseError(
                f"expected {value or kind}, got {got.value or got.kind!r} "
                f"at {got.pos}")
        return t

    def at_keyword(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "KEYWORD" and t.value in kws

    # -- entry --------------------------------------------------------------
    def parse_statement(self):
        """SELECT or a UNION [ALL] chain of SELECTs."""
        stmt = self.parse_union_chain()
        self.expect("EOF")
        return stmt

    def parse_any(self):
        """Query OR DDL statement (``executeSql`` dispatch surface)."""
        if self.at_word("CREATE"):
            return self.parse_create()
        if self.at_word("DROP"):
            return self.parse_drop()
        if self.at_word("SHOW"):
            self.next()
            self.expect_word("TABLES")
            self.expect("EOF")
            return ShowTablesStmt()
        if self.at_word("DESCRIBE") or self.at_word("DESC"):
            self.next()
            name = self.expect("IDENT").value
            self.expect("EOF")
            return DescribeStmt(name)
        return self.parse_statement()

    # -- DDL ----------------------------------------------------------------
    def parse_create(self):
        self.expect_word("CREATE")
        self.accept_word("TEMPORARY")
        if self.accept_word("VIEW"):
            ine = self._if_not_exists()
            name = self.expect("IDENT").value
            self.expect("KEYWORD", "AS")
            query = self.parse_union_chain()
            self.expect("EOF")
            return CreateViewStmt(name, query, ine)
        self.expect_word("TABLE")
        ine = self._if_not_exists()
        name = self.expect("IDENT").value
        self.expect("OP", "(")
        cols: List[ColumnDef] = []
        wm_col, wm_delay = None, 0
        pkey = None
        while True:
            if self.accept_word("WATERMARK"):
                self.expect_word("FOR")
                wm_col = self.expect("IDENT").value
                self.expect("KEYWORD", "AS")
                e = self.parse_additive()
                # `c` (delay 0) or `c - INTERVAL 'n' UNIT`
                if isinstance(e, Binary) and e.op == "-" \
                        and isinstance(e.right, Interval):
                    wm_delay = e.right.ms
                elif not isinstance(e, Column):
                    raise SqlParseError(
                        "WATERMARK expression must be <col> or "
                        "<col> - INTERVAL '...' <unit>")
            elif self.at_word("PRIMARY"):
                self.next()
                self.expect_word("KEY")
                self.expect("OP", "(")
                pkey = self.expect("IDENT").value
                self.expect("OP", ")")
                if self.accept("KEYWORD", "NOT"):
                    self.expect_word("ENFORCED")
            else:
                cname = self.expect("IDENT").value
                cols.append(ColumnDef(cname, self._parse_type()))
            if not self.accept("OP", ","):
                break
        self.expect("OP", ")")
        self.expect_word("WITH")
        self.expect("OP", "(")
        props = {}
        while True:
            k = self.expect("STRING").value
            self.expect("OP", "=")
            props[k.lower()] = self.expect("STRING").value
            if not self.accept("OP", ","):
                break
        self.expect("OP", ")")
        self.expect("EOF")
        return CreateTableStmt(name, cols, props, wm_col, wm_delay, pkey, ine)

    def _parse_type(self) -> str:
        t = self.peek()
        if t.kind == "KEYWORD" and t.value == "TIMESTAMP":
            self.next()
            base = "TIMESTAMP"
        else:
            base = self.expect("IDENT").value.upper()
        if self.accept("OP", "("):
            args = [self.expect("NUMBER").value]
            while self.accept("OP", ","):
                args.append(self.expect("NUMBER").value)
            self.expect("OP", ")")
            base += f"({', '.join(args)})"
        return base

    def _if_not_exists(self) -> bool:
        if self.at_word("IF"):
            self.next()
            self.expect("KEYWORD", "NOT")
            self.expect_word("EXISTS")
            return True
        return False

    def parse_drop(self):
        self.expect_word("DROP")
        kind = "VIEW" if self.accept_word("VIEW") else None
        if kind is None:
            self.expect_word("TABLE")
            kind = "TABLE"
        ife = False
        if self.at_word("IF"):
            self.next()
            self.expect_word("EXISTS")
            ife = True
        name = self.expect("IDENT").value
        self.expect("EOF")
        return DropStmt(kind, name, ife)

    def parse_union_chain(self):
        left = self.parse_select(expect_eof=False)
        parts = [left]
        alls: List[bool] = []
        while self.accept("KEYWORD", "UNION"):
            alls.append(bool(self.accept("KEYWORD", "ALL")))
            parts.append(self.parse_select(expect_eof=False))
        if len(parts) == 1:
            return left
        # standard SQL: a trailing ORDER BY/LIMIT binds to the WHOLE union
        last = parts[-1]
        order_by, limit = list(last.order_by), last.limit
        last.order_by, last.limit = [], None
        for p in parts[:-1]:
            if p.order_by or p.limit is not None:
                raise SqlParseError(
                    "ORDER BY/LIMIT inside a UNION branch is not supported "
                    "(put them after the last SELECT)")
        return UnionStmt(parts=parts, alls=alls, order_by=order_by,
                         limit=limit)

    def parse_select(self, expect_eof: bool = True) -> SelectStmt:
        self.expect("KEYWORD", "SELECT")
        items = [self.parse_select_item()]
        while self.accept("OP", ","):
            items.append(self.parse_select_item())
        table = None
        table_alias = None
        match_clause = None
        joins: List[JoinClause] = []
        if self.accept("KEYWORD", "FROM"):
            if self.accept("OP", "("):
                table = self.parse_union_chain()
                self.expect("OP", ")")
            else:
                table = self.expect("IDENT").value
            if self.at_word("MATCH_RECOGNIZE"):
                match_clause = self.parse_match_recognize()
            elif self.accept("KEYWORD", "AS"):
                table_alias = self.expect("IDENT").value
            elif self.peek().kind == "IDENT":
                table_alias = self.next().value
            while self.at_keyword("JOIN", "INNER", "LEFT", "RIGHT", "FULL"):
                kind = "inner"
                if self.accept("KEYWORD", "INNER"):
                    pass
                elif self.accept("KEYWORD", "LEFT"):
                    kind = "left"
                    self.accept("KEYWORD", "OUTER")
                elif self.accept("KEYWORD", "RIGHT"):
                    kind = "right"
                    self.accept("KEYWORD", "OUTER")
                elif self.accept("KEYWORD", "FULL"):
                    kind = "full"
                    self.accept("KEYWORD", "OUTER")
                self.expect("KEYWORD", "JOIN")
                jt = self.expect("IDENT").value
                sys_time = None
                if self.accept_word("FOR"):
                    self.expect_word("SYSTEM_TIME")
                    self.expect("KEYWORD", "AS")
                    self.expect_word("OF")
                    sys_time = self.parse_additive()
                jalias = None
                if self.accept("KEYWORD", "AS"):
                    jalias = self.expect("IDENT").value
                elif self.peek().kind == "IDENT":
                    jalias = self.next().value
                self.expect("KEYWORD", "ON")
                on = self.parse_expr()
                joins.append(JoinClause(jt, jalias, kind, on,
                                        system_time_of=sys_time))
        stmt = SelectStmt(items=items, table=table, table_alias=table_alias,
                          joins=joins, match=match_clause)
        if self.accept("KEYWORD", "WHERE"):
            stmt.where = self.parse_expr()
        if self.accept("KEYWORD", "GROUP"):
            self.expect("KEYWORD", "BY")
            stmt.group_by.append(self.parse_expr())
            while self.accept("OP", ","):
                stmt.group_by.append(self.parse_expr())
        if self.accept("KEYWORD", "HAVING"):
            stmt.having = self.parse_expr()
        if self.accept("KEYWORD", "ORDER"):
            self.expect("KEYWORD", "BY")
            stmt.order_by.append(self.parse_order_item())
            while self.accept("OP", ","):
                stmt.order_by.append(self.parse_order_item())
        if self.accept("KEYWORD", "LIMIT"):
            stmt.limit = int(self.expect("NUMBER").value)
        if expect_eof:
            self.expect("EOF")
        return stmt

    def parse_order_item(self) -> Tuple[Expr, bool]:
        e = self.parse_expr()
        asc = True
        if self.accept("KEYWORD", "DESC"):
            asc = False
        else:
            self.accept("KEYWORD", "ASC")
        return (e, asc)

    def parse_select_item(self) -> SelectItem:
        if self.accept("OP", "*"):
            return SelectItem(Star())
        e = self.parse_expr()
        alias = None
        if self.accept("KEYWORD", "AS"):
            alias = self.expect("IDENT").value
        elif self.peek().kind == "IDENT":
            alias = self.next().value
        return SelectItem(e, alias)

    # -- expressions (precedence climbing) ----------------------------------
    def parse_expr(self) -> Expr:
        return self.parse_or()

    def parse_or(self) -> Expr:
        e = self.parse_and()
        while self.accept("KEYWORD", "OR"):
            e = Binary("OR", e, self.parse_and())
        return e

    def parse_and(self) -> Expr:
        e = self.parse_not()
        while self.accept("KEYWORD", "AND"):
            e = Binary("AND", e, self.parse_not())
        return e

    def parse_not(self) -> Expr:
        if self.accept("KEYWORD", "NOT"):
            return Unary("NOT", self.parse_not())
        return self.parse_predicate()

    def parse_predicate(self) -> Expr:
        e = self.parse_additive()
        negated = bool(self.accept("KEYWORD", "NOT"))
        if self.accept("KEYWORD", "BETWEEN"):
            lo = self.parse_additive()
            self.expect("KEYWORD", "AND")
            hi = self.parse_additive()
            return Between(e, lo, hi, negated)
        if self.accept("KEYWORD", "IN"):
            self.expect("OP", "(")
            items = [self.parse_expr()]
            while self.accept("OP", ","):
                items.append(self.parse_expr())
            self.expect("OP", ")")
            return InList(e, tuple(items), negated)
        if self.accept("KEYWORD", "LIKE"):
            pat = self.expect("STRING").value
            return Like(e, pat, negated)
        if negated:
            raise SqlParseError("NOT must be followed by BETWEEN/IN/LIKE here")
        if self.accept("KEYWORD", "IS"):
            neg = bool(self.accept("KEYWORD", "NOT"))
            self.expect("KEYWORD", "NULL")
            return IsNull(e, neg)
        t = self.peek()
        if t.kind == "OP" and t.value in ("=", "<>", "!=", "<", "<=", ">", ">="):
            self.next()
            op = "<>" if t.value == "!=" else t.value
            return Binary(op, e, self.parse_additive())
        return e

    def parse_additive(self) -> Expr:
        e = self.parse_multiplicative()
        while True:
            t = self.peek()
            if t.kind == "OP" and t.value in ("+", "-", "||"):
                self.next()
                e = Binary(t.value, e, self.parse_multiplicative())
            else:
                return e

    def parse_multiplicative(self) -> Expr:
        e = self.parse_unary()
        while True:
            t = self.peek()
            if t.kind == "OP" and t.value in ("*", "/", "%"):
                self.next()
                e = Binary(t.value, e, self.parse_unary())
            else:
                return e

    def parse_unary(self) -> Expr:
        if self.accept("OP", "-"):
            return Unary("-", self.parse_unary())
        if self.accept("OP", "+"):
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self) -> Expr:
        t = self.peek()
        if t.kind == "NUMBER":
            self.next()
            v = float(t.value) if ("." in t.value or "e" in t.value.lower()) \
                else int(t.value)
            return Literal(v)
        if t.kind == "STRING":
            self.next()
            return Literal(t.value)
        if self.accept("KEYWORD", "TRUE"):
            return Literal(True)
        if self.accept("KEYWORD", "FALSE"):
            return Literal(False)
        if self.accept("KEYWORD", "NULL"):
            return Literal(None)
        if self.accept("KEYWORD", "INTERVAL"):
            val = self.expect("STRING").value
            unit_tok = self.expect("IDENT")
            unit = unit_tok.value.upper()
            if unit not in _UNIT_MS:
                raise SqlParseError(f"unknown interval unit {unit!r}")
            return Interval(int(float(val) * _UNIT_MS[unit]))
        if self.accept("KEYWORD", "DATE"):
            return Literal(_date_to_ms(self.expect("STRING").value))
        if self.accept("KEYWORD", "TIMESTAMP"):
            return Literal(_timestamp_to_ms(self.expect("STRING").value))
        if self.accept("KEYWORD", "CAST"):
            self.expect("OP", "(")
            e = self.parse_expr()
            self.expect("KEYWORD", "AS")
            ty = self.expect("IDENT").value.upper()
            # swallow precision, e.g. DECIMAL(12, 2)
            if self.accept("OP", "("):
                while not self.accept("OP", ")"):
                    self.next()
            self.expect("OP", ")")
            return Cast(e, ty)
        if self.accept("KEYWORD", "CASE"):
            whens = []
            while self.accept("KEYWORD", "WHEN"):
                cond = self.parse_expr()
                self.expect("KEYWORD", "THEN")
                whens.append((cond, self.parse_expr()))
            default = None
            if self.accept("KEYWORD", "ELSE"):
                default = self.parse_expr()
            self.expect("KEYWORD", "END")
            return Case(tuple(whens), default)
        if self.accept("OP", "("):
            e = self.parse_expr()
            self.expect("OP", ")")
            return e
        if t.kind == "IDENT":
            self.next()
            name = t.value
            if self.accept("OP", "("):
                call = self.parse_call(name)
                if self.at_keyword("OVER"):
                    return self.parse_over(call)
                return call
            # qualified column: tbl.col keeps its qualifier (join resolution)
            qualifier = None
            while self.accept("OP", "."):
                qualifier = name if qualifier is None else f"{qualifier}.{name}"
                name = self.expect("IDENT").value
            return Column(name, table=qualifier)
        raise SqlParseError(f"unexpected token {t.value or t.kind!r} at {t.pos}")

    def parse_match_recognize(self) -> MatchRecognizeClause:
        """``MATCH_RECOGNIZE ( ... ) [AS alias]`` — clause words are
        contextual (IDENT tokens), matching Calcite's non-reserved
        treatment, so MEASURES/PATTERN/DEFINE stay usable as column
        names elsewhere."""
        self.expect_word("MATCH_RECOGNIZE")
        self.expect("OP", "(")
        partition_by: List[str] = []
        order_by = None
        measures: List[SelectItem] = []
        after_match = "skip_to_next"
        pattern: List[MatchStage] = []
        defines: dict = {}
        within_ms = None
        if self.accept("KEYWORD", "PARTITION"):
            self.expect("KEYWORD", "BY")
            partition_by.append(self.expect("IDENT").value)
            while self.accept("OP", ","):
                partition_by.append(self.expect("IDENT").value)
        if self.accept("KEYWORD", "ORDER"):
            self.expect("KEYWORD", "BY")
            order_by = self.expect("IDENT").value
            self.accept("KEYWORD", "ASC")
        if order_by is None:
            raise SqlParseError("MATCH_RECOGNIZE requires ORDER BY")
        if self.accept_word("MEASURES"):
            measures.append(self.parse_select_item())
            while self.accept("OP", ","):
                measures.append(self.parse_select_item())
        if self.accept_word("ONE"):
            self.expect_word("ROW")
            self.expect_word("PER")
            self.expect_word("MATCH")
        elif self.accept("KEYWORD", "ALL"):
            raise SqlParseError("ALL ROWS PER MATCH is not supported "
                                "(use ONE ROW PER MATCH)")
        if self.accept_word("AFTER"):
            self.expect_word("MATCH")
            self.expect_word("SKIP")
            if self.accept_word("PAST"):
                self.expect_word("LAST")
                self.expect_word("ROW")
                after_match = "skip_past_last"
            elif self.accept_word("TO"):
                self.expect_word("NEXT")
                self.expect_word("ROW")
                after_match = "skip_to_next"
            else:
                raise SqlParseError("AFTER MATCH SKIP must be PAST LAST ROW "
                                    "or TO NEXT ROW")
        self.expect_word("PATTERN")
        self.expect("OP", "(")
        while not self.accept("OP", ")"):
            var = self.expect("IDENT").value
            st = MatchStage(var)
            if self.accept("OP", "+"):
                st = MatchStage(var, 1, None)
            elif self.accept("OP", "*"):
                st = MatchStage(var, 1, None, optional=True)
            elif self.accept("OP", "?"):
                st = MatchStage(var, 1, 1, optional=True)
            elif self.accept("OP", "{"):
                lo = int(self.expect("NUMBER").value)
                hi = lo
                if self.accept("OP", ","):
                    # {n,} = at least n; {n,m} = between n and m
                    hi = (int(self.next().value)
                          if self.peek().kind == "NUMBER" else None)
                self.expect("OP", "}")
                st = MatchStage(var, lo, hi)
            pattern.append(st)
        if not pattern:
            raise SqlParseError("PATTERN must name at least one variable")
        if self.accept_word("WITHIN"):
            e = self.parse_primary()
            if not isinstance(e, Interval):
                raise SqlParseError("WITHIN takes INTERVAL '...' <unit>")
            within_ms = e.ms
        self.expect_word("DEFINE")
        while True:
            var = self.expect("IDENT").value
            self.expect("KEYWORD", "AS")
            defines[var.upper()] = self.parse_expr()
            if not self.accept("OP", ","):
                break
        self.expect("OP", ")")
        alias = None
        if self.accept("KEYWORD", "AS"):
            alias = self.expect("IDENT").value
        elif self.peek().kind == "IDENT":
            alias = self.next().value
        return MatchRecognizeClause(
            partition_by=partition_by, order_by=order_by, measures=measures,
            pattern=pattern, defines=defines, after_match=after_match,
            within_ms=within_ms, alias=alias)

    def parse_over(self, call: Expr) -> "OverCall":
        self.expect("KEYWORD", "OVER")
        self.expect("OP", "(")
        partition = order = None
        asc = True
        frame_rows = frame_range_ms = None
        if self.accept("KEYWORD", "PARTITION"):
            self.expect("KEYWORD", "BY")
            partition = self.parse_expr()
        if self.accept("KEYWORD", "ORDER"):
            self.expect("KEYWORD", "BY")
            order = self.parse_expr()
            if self.accept("KEYWORD", "DESC"):
                asc = False
            else:
                self.accept("KEYWORD", "ASC")
        is_rows = False
        if self.at_word("ROWS") or self.at_word("RANGE"):
            frame_rows, frame_range_ms, is_rows = self.parse_frame()
        self.expect("OP", ")")
        if not isinstance(call, Call):
            raise SqlParseError("OVER must follow a function call")
        return OverCall(call.name, partition, order, asc,
                        args=call.args, frame_rows=frame_rows,
                        frame_range_ms=frame_range_ms, frame_is_rows=is_rows,
                        distinct=call.distinct)

    # frame words are contextual (IDENT tokens), not reserved keywords
    def at_word(self, word: str) -> bool:
        t = self.peek()
        return t.kind == "IDENT" and t.value.upper() == word

    def accept_word(self, word: str) -> bool:
        if self.at_word(word):
            self.next()
            return True
        return False

    def expect_word(self, word: str) -> None:
        if not self.accept_word(word):
            t = self.peek()
            raise SqlParseError(
                f"expected {word} at {t.pos}, got {t.value or t.kind!r}")

    def parse_frame(self):
        """``ROWS|RANGE [BETWEEN] <bound> PRECEDING [AND CURRENT ROW]`` →
        (frame_rows, frame_range_ms, is_rows); UNBOUNDED → (None, None, _)."""
        is_rows = self.accept_word("ROWS")
        if not is_rows:
            self.expect_word("RANGE")
        self.accept("KEYWORD", "BETWEEN")
        frame_rows = frame_range_ms = None
        if self.accept_word("UNBOUNDED"):
            pass  # unbounded preceding = the default frame
        elif is_rows:
            t = self.expect("NUMBER")
            frame_rows = int(float(t.value))
        else:
            e = self.parse_primary()
            if not isinstance(e, Interval):
                raise SqlParseError(
                    "RANGE frame bound must be INTERVAL '...' PRECEDING")
            frame_range_ms = e.ms
        self.expect_word("PRECEDING")
        if self.accept("KEYWORD", "AND"):
            self.expect_word("CURRENT")
            self.expect_word("ROW")
        return frame_rows, frame_range_ms, is_rows

    def parse_call(self, name: str) -> Expr:
        up = name.upper()
        if self.accept("OP", ")"):
            return Call(up, ())
        if up == "COUNT" and self.accept("OP", "*"):
            self.expect("OP", ")")
            return Call("COUNT", (Star(),))
        distinct = bool(self.accept("KEYWORD", "DISTINCT"))
        args = [self.parse_expr()]
        while self.accept("OP", ","):
            args.append(self.parse_expr())
        self.expect("OP", ")")
        return Call(up, tuple(args), distinct)


def _date_to_ms(s: str) -> int:
    y, m, d = (int(x) for x in s.strip().split("-"))
    import datetime
    epoch = datetime.date(1970, 1, 1)
    return (datetime.date(y, m, d) - epoch).days * 86_400_000


def _timestamp_to_ms(s: str) -> int:
    import datetime
    s = s.strip()
    fmt = "%Y-%m-%d %H:%M:%S.%f" if "." in s else (
        "%Y-%m-%d %H:%M:%S" if " " in s else "%Y-%m-%d")
    dt = datetime.datetime.strptime(s, fmt).replace(
        tzinfo=datetime.timezone.utc)
    return int(dt.timestamp() * 1000)


def parse(sql: str):
    """-> SelectStmt | UnionStmt."""
    return Parser(sql.strip().rstrip(";")).parse_statement()


def parse_any(sql: str):
    """-> query statement OR a DDL statement (CREATE/DROP/SHOW/DESCRIBE)."""
    return Parser(sql.strip().rstrip(";")).parse_any()

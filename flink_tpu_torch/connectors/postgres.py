"""PostgreSQL wire protocol (v3): client + server + JDBC-analog connector.

The port's copy of ``flink_tpu/connectors/postgres.py``: host Python as
JAX's, the same bytes on the wire and on disk, so either package's client
talks to the other's server.

The reference's JDBC connector
(``flink-connectors/flink-connector-jdbc/.../JdbcSink.java:37``,
``JdbcRowDataInputFormat``, Postgres dialect under ``catalog/`` and
``dialect/``) reaches relational stores through the JDBC driver stack.
There is no JVM here, so this module implements the layer the driver
abstracts: PostgreSQL's frontend/backend protocol version 3, from first
principles —

- **Framing**: 1-byte message type + int32 length (length includes
  itself); the StartupMessage alone omits the type byte.
- **Handshake**: StartupMessage (protocol 196608, ``user``/``database``
  params) → AuthenticationOk or AuthenticationMD5Password (4-byte salt;
  response ``md5`` + hex(md5(hex(md5(password+user)) + salt))) →
  ParameterStatus* → BackendKeyData → ReadyForQuery.
- **Simple query cycle** ('Q'): RowDescription ('T', field name + type
  OID + text format) → DataRow* ('D', int32-length-prefixed text cells,
  -1 = NULL) → CommandComplete ('C', e.g. ``SELECT 5``) →
  ReadyForQuery; ErrorResponse ('E') with severity/SQLSTATE/message
  fields on failure.

:class:`PostgresWireServer` serves the dialect over in-memory tables with
a minimal SQL engine (CREATE/DROP TABLE, multi-row INSERT with
``ON CONFLICT`` upsert, SELECT with conjunctive WHERE / ORDER BY / LIMIT,
MIN/MAX/COUNT aggregates) plus real transaction control: BEGIN / COMMIT /
ROLLBACK and **two-phase commit** — ``PREPARE TRANSACTION 'gid'`` /
``COMMIT PREPARED`` / ``ROLLBACK PREPARED`` — the primitive under the
reference's XA exactly-once sink
(``JdbcXaSinkFunction.java``, ``XaFacadeImpl.java``).  Prepared
transactions optionally persist to disk and committed gids are
remembered, so a replayed ``COMMIT PREPARED`` after restore is
idempotent.

:class:`PostgresWireClient` speaks the dialect against ANY v3 server
(including real PostgreSQL, for trust/md5 auth and the statement subset).
:class:`PostgresSource` is the FLIP-27 adapter: numeric-range partitioned
scans (``JdbcNumericBetweenParametersProvider.java:42``) with positioned
readers, so checkpoints resume mid-split.  :class:`PostgresSink` buffers
multi-row INSERTs (``JdbcSink.sink`` / ``JdbcBatchingOutputFormat``
analog) and, in exactly-once mode, stages each checkpoint epoch as a
prepared transaction committed on checkpoint completion
(``JdbcSink.exactlyOnceSink:101`` analog).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import socket
import struct
import threading
from socketserver import BaseRequestHandler
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from flink_tpu_torch.core.batch import RecordBatch, StreamElement
from flink_tpu_torch.connectors.sources import Source, SourceSplit
from flink_tpu_torch.connectors.sinks import Sink
from flink_tpu_torch.utils.servers import ThreadingTCPServer, stop_serving

PROTOCOL_V3 = 196608  # 3 << 16

#: type name -> (oid, numpy dtype); OIDs are PostgreSQL's pg_type values
_TYPES = {
    "bool": (16, np.dtype(bool)),
    "int8": (20, np.dtype(np.int64)),
    "int4": (23, np.dtype(np.int32)),
    "text": (25, np.dtype(object)),
    "float4": (700, np.dtype(np.float32)),
    "float8": (701, np.dtype(np.float64)),
}
_TYPE_ALIASES = {
    "boolean": "bool", "bigint": "int8", "int": "int4", "integer": "int4",
    "smallint": "int4", "real": "float4", "double": "float8",
    "double precision": "float8", "varchar": "text", "string": "text",
}
_OID_DTYPE = {oid: dt for oid, dt in _TYPES.values()}
_OID_DTYPE[20] = np.dtype(np.int64)


def _canon_type(name: str) -> str:
    name = re.sub(r"\(.*\)", "", name.strip().lower()).strip()
    return _TYPE_ALIASES.get(name, name)


def md5_password(user: str, password: str, salt: bytes) -> str:
    inner = hashlib.md5((password + user).encode()).hexdigest()
    return "md5" + hashlib.md5(inner.encode() + salt).hexdigest()


# ---------------------------------------------------------------------------
# wire encode/decode
# ---------------------------------------------------------------------------

def _msg(type_byte: bytes, payload: bytes) -> bytes:
    return type_byte + struct.pack(">i", len(payload) + 4) + payload


def _cstr(s: str) -> bytes:
    return s.encode() + b"\0"


def _read_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def read_message(sock) -> Tuple[bytes, bytes]:
    """One framed backend/frontend message -> (type byte, payload)."""
    t = _read_exact(sock, 1)
    (ln,) = struct.unpack(">i", _read_exact(sock, 4))
    return t, _read_exact(sock, ln - 4)


def _row_description(fields: Sequence[Tuple[str, int]]) -> bytes:
    out = [struct.pack(">h", len(fields))]
    for name, oid in fields:
        out.append(_cstr(name))
        out.append(struct.pack(">ihihih", 0, 0, oid, -1, -1, 0))
    return _msg(b"T", b"".join(out))


def _data_row(cells: Sequence[Optional[str]]) -> bytes:
    out = [struct.pack(">h", len(cells))]
    for c in cells:
        if c is None:
            out.append(struct.pack(">i", -1))
        else:
            b = c.encode()
            out.append(struct.pack(">i", len(b)) + b)
    return _msg(b"D", b"".join(out))


def _error(message: str, sqlstate: str = "42601") -> bytes:
    body = (b"S" + _cstr("ERROR") + b"C" + _cstr(sqlstate)
            + b"M" + _cstr(message) + b"\0")
    return _msg(b"E", body)


def _text_cell(v) -> Optional[str]:
    if v is None:
        return None
    if isinstance(v, (bool, np.bool_)):
        return "t" if v else "f"
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return str(v)


def _parse_cell(s: Optional[str], dtype: np.dtype):
    if s is None:
        return None
    if dtype == np.dtype(bool):
        return s in ("t", "true", "1")
    if np.issubdtype(dtype, np.integer):
        return int(s)
    if np.issubdtype(dtype, np.floating):
        return float(s)
    return s


# ---------------------------------------------------------------------------
# minimal SQL engine (server side)
# ---------------------------------------------------------------------------

_LIT = (r"(?:'(?:[^']|'')*'|[+-]?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?"
        r"|[+-]?(?:NaN|Inf(?:inity)?)|NULL|TRUE|FALSE)")


def _parse_literal(tok: str):
    t = tok.strip()
    up = t.upper()
    if up == "NULL":
        return None
    if up == "TRUE":
        return True
    if up == "FALSE":
        return False
    if up in ("NAN", "+NAN", "-NAN"):
        return float("nan")
    if up in ("INF", "INFINITY", "+INF", "+INFINITY"):
        return float("inf")
    if up in ("-INF", "-INFINITY"):
        return float("-inf")
    if t.startswith("'"):
        return t[1:-1].replace("''", "'")
    return float(t) if ("." in t or "e" in t or "E" in t) else int(t)


def _split_statements(sql: str) -> List[str]:
    """Split on top-level ';' only — semicolons inside single-quoted
    literals (with '' escapes) belong to the statement."""
    out, start, i, n = [], 0, 0, len(sql)
    in_str = False
    while i < n:
        c = sql[i]
        if in_str:
            if c == "'":
                if i + 1 < n and sql[i + 1] == "'":
                    i += 1          # escaped quote
                else:
                    in_str = False
        elif c == "'":
            in_str = True
        elif c == ";":
            out.append(sql[start:i])
            start = i + 1
        i += 1
    out.append(sql[start:])
    return [s for s in out if s.strip()]


def _split_tuples(values_sql: str) -> List[str]:
    """Top-level parenthesized tuple bodies of a VALUES list, quote-aware.
    Raises on anything that is not tuples separated by commas — a tuple
    the parser cannot read must be an ERROR, never a silent drop."""
    out, i, n = [], 0, len(values_sql)
    while i < n:
        c = values_sql[i]
        if c.isspace() or c == ",":
            i += 1
            continue
        if c != "(":
            raise ValueError(f"malformed VALUES near: {values_sql[i:i+20]!r}")
        depth, in_str, j = 1, False, i + 1
        while j < n and depth:
            cj = values_sql[j]
            if in_str:
                if cj == "'":
                    if j + 1 < n and values_sql[j + 1] == "'":
                        j += 1
                    else:
                        in_str = False
            elif cj == "'":
                in_str = True
            elif cj == "(":
                depth += 1
            elif cj == ")":
                depth -= 1
            j += 1
        if depth:
            raise ValueError("malformed VALUES: unbalanced parentheses")
        out.append(values_sql[i + 1:j - 1])
        i = j
    if not out:
        raise ValueError("malformed VALUES")
    return out


def _split_tuple_literals(body: str) -> List[str]:
    """Comma-separated literals of ONE tuple; every byte must be consumed
    by a literal (strict — no skipping)."""
    lits, pos, n = [], 0, len(body)
    pat = re.compile(r"\s*(%s)\s*(,|$)" % _LIT, re.I)
    while pos < n or not lits:
        m = pat.match(body, pos)
        if not m:
            raise ValueError(f"unsupported literal near: {body[pos:pos+20]!r}")
        lits.append(m.group(1))
        pos = m.end()
        if m.group(2) != ",":
            break
    if pos < n and body[pos:].strip():
        raise ValueError(f"unsupported literal near: {body[pos:pos+20]!r}")
    return lits


@dataclass
class _Table:
    name: str
    columns: List[str]
    types: List[str]              # canonical type names
    pkey: Optional[str] = None
    rows: Dict[str, list] = field(default_factory=dict)  # col -> values
    pk_index: Dict[Any, int] = field(default_factory=dict)

    def __post_init__(self):
        if not self.rows:
            self.rows = {c: [] for c in self.columns}

    def nrows(self) -> int:
        return len(self.rows[self.columns[0]]) if self.columns else 0

    def insert(self, cols: List[str], values: List[list], on_conflict: str):
        """``on_conflict``: "error" (plain INSERT), "update" (DO UPDATE),
        or "ignore" (DO NOTHING)."""
        missing = [c for c in cols if c not in self.columns]
        if missing:
            raise ValueError(f"column {missing[0]} does not exist")
        for row in values:
            asmap = dict(zip(cols, row))
            if self.pkey is not None and self.pkey in asmap:
                pk = asmap[self.pkey]
                at = self.pk_index.get(pk)
                if at is not None:
                    if on_conflict == "error":
                        raise ValueError(
                            f"duplicate key value violates unique "
                            f"constraint on {self.pkey}")
                    if on_conflict == "update":
                        for c, v in asmap.items():
                            self.rows[c][at] = v
                    continue          # "ignore": row dropped
                self.pk_index[pk] = self.nrows()
            for c in self.columns:
                self.rows[c].append(asmap.get(c))

    def oid_of(self, col: str) -> int:
        return _TYPES[self.types[self.columns.index(col)]][0]

    def dtype_of(self, col: str) -> np.dtype:
        return _TYPES[self.types[self.columns.index(col)]][1]


class _MiniSql:
    """The statement subset the wire server evaluates (enough for the
    connector seams and for foreign clients doing the same shapes)."""

    def __init__(self, server: "PostgresWireServer"):
        self.srv = server

    # each handler returns (command_tag, fields, rows) — fields None for
    # statements that produce no result set
    def execute(self, sql: str, txn: "_TxnState"):
        s = sql.strip().rstrip(";").strip()
        if not s:
            return ("EMPTY", None, None)
        up = s.upper()
        if up == "BEGIN" or up.startswith("BEGIN "):
            txn.explicit = True
            return ("BEGIN", None, None)
        if up == "COMMIT":
            # validate-then-apply, mirroring COMMIT PREPARED: a constraint
            # violation must roll the whole txn back, not leave the rows
            # staged before the offending one committed.  The (reentrant)
            # server lock spans BOTH steps — a concurrent commit applying
            # between validate and apply would re-introduce partial commits
            with self.srv._lock:
                self.srv._validate_staged(txn.staged)
                self.srv._apply_staged(txn.staged)
            txn.reset()
            return ("COMMIT", None, None)
        if up == "ROLLBACK":
            txn.reset()
            return ("ROLLBACK", None, None)
        m = re.match(r"PREPARE\s+TRANSACTION\s+'([^']*)'$", s, re.I)
        if m:
            self.srv._prepare(m.group(1), txn.staged)
            txn.reset()
            return ("PREPARE TRANSACTION", None, None)
        m = re.match(r"COMMIT\s+PREPARED\s+'([^']*)'$", s, re.I)
        if m:
            self.srv._commit_prepared(m.group(1))
            return ("COMMIT PREPARED", None, None)
        m = re.match(r"ROLLBACK\s+PREPARED\s+'([^']*)'$", s, re.I)
        if m:
            self.srv._rollback_prepared(m.group(1))
            return ("ROLLBACK PREPARED", None, None)
        if up.startswith("CREATE TABLE"):
            return self._create(s)
        if up.startswith("DROP TABLE"):
            return self._drop(s)
        if up.startswith("INSERT"):
            return self._insert(s, txn)
        if up.startswith("SELECT"):
            return self._select(s)
        raise ValueError(f"unsupported statement: {s.split()[0]}")

    def _create(self, s: str):
        m = re.match(r"CREATE\s+TABLE\s+(IF\s+NOT\s+EXISTS\s+)?(\w+)\s*\((.*)\)$",
                     s, re.I | re.S)
        if not m:
            raise ValueError("malformed CREATE TABLE")
        if_not, name, body = m.group(1), m.group(2).lower(), m.group(3)
        with self.srv._lock:
            if name in self.srv.tables:
                if if_not:
                    return ("CREATE TABLE", None, None)
                raise ValueError(f"relation {name} already exists")
            cols, types, pkey = [], [], None
            for part in re.split(r",(?![^()]*\))", body):
                part = part.strip()
                pm = re.match(r"(\w+)\s+([\w ]+?)(\s+PRIMARY\s+KEY)?$",
                              part, re.I)
                if not pm:
                    raise ValueError(f"malformed column def: {part}")
                cname = pm.group(1).lower()
                ctype = _canon_type(pm.group(2))
                if ctype not in _TYPES:
                    raise ValueError(f"unknown type {pm.group(2).strip()}")
                cols.append(cname)
                types.append(ctype)
                if pm.group(3):
                    pkey = cname
            self.srv.tables[name] = _Table(name, cols, types, pkey)
        return ("CREATE TABLE", None, None)

    def _drop(self, s: str):
        m = re.match(r"DROP\s+TABLE\s+(IF\s+EXISTS\s+)?(\w+)$", s, re.I)
        if not m:
            raise ValueError("malformed DROP TABLE")
        with self.srv._lock:
            if m.group(2).lower() not in self.srv.tables and not m.group(1):
                raise ValueError(f"relation {m.group(2)} does not exist")
            self.srv.tables.pop(m.group(2).lower(), None)
        return ("DROP TABLE", None, None)

    def _insert(self, s: str, txn: "_TxnState"):
        m = re.match(
            r"INSERT\s+INTO\s+(\w+)\s*\(([^)]*)\)\s*VALUES\s*(.*?)"
            r"(\s+ON\s+CONFLICT\s*(?:\([^)]*\))?\s*DO\s+(UPDATE|NOTHING)"
            r".*)?$",
            s, re.I | re.S)
        if not m:
            raise ValueError("malformed INSERT")
        table = m.group(1).lower()
        cols = [c.strip().lower() for c in m.group(2).split(",")]
        on_conflict = ("error" if m.group(5) is None
                       else ("update" if m.group(5).upper() == "UPDATE"
                             else "ignore"))
        values = []
        for t in _split_tuples(m.group(3)):
            lits = _split_tuple_literals(t)
            if len(lits) != len(cols):
                raise ValueError("INSERT has more/fewer expressions than "
                                 "target columns")
            values.append([_parse_literal(l) for l in lits])
        with self.srv._lock:
            if table not in self.srv.tables:
                raise ValueError(f"relation {table} does not exist")
        op = ("insert", table, cols, values, on_conflict)
        if txn.explicit:
            txn.staged.append(op)
        else:
            self.srv._apply_staged([op])
        return (f"INSERT 0 {len(values)}", None, None)

    def _where_mask(self, t: _Table, clause: Optional[str]) -> np.ndarray:
        n = t.nrows()
        mask = np.ones(n, bool)
        if not clause:
            return mask
        for cond in re.split(r"\s+AND\s+", clause.strip(), flags=re.I):
            cm = re.match(r"(\w+)\s*(=|<>|!=|<=|>=|<|>)\s*(%s)$" % _LIT,
                          cond.strip(), re.I)
            if not cm:
                raise ValueError(f"unsupported WHERE condition: {cond}")
            col, op, lit = cm.group(1).lower(), cm.group(2), \
                _parse_literal(cm.group(3))
            if col not in t.columns:
                raise ValueError(f"column {col} does not exist")
            vals = np.asarray(t.rows[col], dtype=object)
            present = np.asarray([v is not None for v in vals.tolist()], bool)
            cmpv = np.zeros(n, bool)
            if present.any():
                lhs = vals[present]
                try:
                    lhs = lhs.astype(t.dtype_of(col))
                except (TypeError, ValueError):
                    pass
                res = {"=": lhs == lit, "<>": lhs != lit, "!=": lhs != lit,
                       "<": lhs < lit, ">": lhs > lit,
                       "<=": lhs <= lit, ">=": lhs >= lit}[op]
                cmpv[np.flatnonzero(present)] = res
            mask &= cmpv
        return mask

    def _select(self, s: str):
        m = re.match(
            r"SELECT\s+(.*?)\s+FROM\s+(\w+)"
            r"(?:\s+WHERE\s+(.*?))?"
            r"(?:\s+ORDER\s+BY\s+(\w+)(\s+DESC|\s+ASC)?)?"
            r"(?:\s+LIMIT\s+(\d+))?$", s, re.I | re.S)
        if not m:
            raise ValueError("malformed SELECT")
        proj, table, where, order, direction, limit = m.groups()
        with self.srv._lock:
            if table.lower() == "pg_prepared_xacts":
                # the catalog view real PostgreSQL exposes for dangling 2PC
                # txns — materialized as a transient relation so the generic
                # path below evaluates projections/aggregates/WHERE/ORDER/
                # LIMIT on it like any other table
                t = _Table("pg_prepared_xacts", ["gid"], ["text"],
                           rows={"gid": sorted(self.srv.prepared)})
            else:
                t = self.srv.tables.get(table.lower())
            if t is None:
                raise ValueError(f"relation {table} does not exist")
            mask = self._where_mask(t, where)
            idx = np.flatnonzero(mask)
            # aggregates: MIN/MAX/COUNT
            aggs = re.findall(r"(MIN|MAX|COUNT)\s*\(\s*(\*|\w+)\s*\)",
                              proj, re.I)
            if aggs:
                fields, row = [], []
                for fn, col in aggs:
                    fn = fn.upper()
                    if fn == "COUNT":
                        fields.append((f"count", 20))
                        row.append(str(int(idx.size)))
                        continue
                    col = col.lower()
                    vals = [t.rows[col][i] for i in idx.tolist()
                            if t.rows[col][i] is not None]
                    fields.append((fn.lower(), t.oid_of(col)))
                    if not vals:
                        row.append(None)
                    else:
                        row.append(_text_cell(min(vals) if fn == "MIN"
                                              else max(vals)))
                return ("SELECT 1", fields, [row])
            cols = (list(t.columns) if proj.strip() == "*"
                    else [c.strip().lower() for c in proj.split(",")])
            for c in cols:
                if c not in t.columns:
                    raise ValueError(f"column {c} does not exist")
            if order:
                ocol = order.lower()
                if ocol not in t.columns:
                    raise ValueError(f"column {ocol} does not exist")
                key = [t.rows[ocol][i] for i in idx.tolist()]
                # NULLs sort last (PostgreSQL's ASC default); python sort is
                # stable and None-safe via the (is-null, value) key
                srt = sorted(range(len(key)),
                             key=lambda j: (key[j] is None,
                                            key[j] if key[j] is not None
                                            else 0))
                if direction and direction.strip().upper() == "DESC":
                    srt = srt[::-1]
                idx = idx[np.asarray(srt, np.int64)] if srt else idx
            if limit is not None:
                idx = idx[: int(limit)]
            fields = [(c, t.oid_of(c)) for c in cols]
            rows = [[_text_cell(t.rows[c][i]) for c in cols]
                    for i in idx.tolist()]
        return (f"SELECT {len(rows)}", fields, rows)


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


@dataclass
class _TxnState:
    explicit: bool = False
    staged: list = field(default_factory=list)

    def reset(self):
        self.explicit = False
        self.staged = []


class PostgresWireServer:
    """In-process server speaking the v3 dialect (trust, md5, or
    SCRAM-SHA-256 auth; simple AND extended query protocols).

    ``persist_dir`` makes prepared transactions and the committed-gid set
    durable (JSON files), so a 2PC sink's replayed ``COMMIT PREPARED``
    stays idempotent across server restarts."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 users: Optional[Dict[str, str]] = None,
                 persist_dir: Optional[str] = None,
                 auth: str = "md5"):
        if auth not in ("md5", "scram-sha-256"):
            raise ValueError(f"unsupported auth {auth!r}")
        self.auth = auth
        self.users = users  # None = trust everyone
        self.tables: Dict[str, _Table] = {}
        self.prepared: Dict[str, list] = {}
        self.committed_gids: set = set()
        self._lock = threading.RLock()
        self.persist_dir = persist_dir
        if persist_dir:
            os.makedirs(persist_dir, exist_ok=True)
            self._load_persisted()
        self._sql = _MiniSql(self)
        srv_self = self

        class Handler(BaseRequestHandler):
            def handle(self):
                try:
                    srv_self._serve_conn(self.request)
                except (ConnectionError, OSError):
                    pass

        class TCP(ThreadingTCPServer):
            allow_reuse_address = True

        self._tcp = TCP((host, port), Handler)
        self.host, self.port = self._tcp.server_address
        self._thread = threading.Thread(target=self._tcp.serve_forever,
                                        daemon=True)
        self._thread.start()

    # -- durability ---------------------------------------------------------
    def _gid_path(self, gid: str) -> str:
        safe = re.sub(r"[^\w.-]", "_", gid)
        return os.path.join(self.persist_dir, f"prepared-{safe}.json")

    def _load_persisted(self):
        cg = os.path.join(self.persist_dir, "committed-gids.json")
        if os.path.exists(cg):
            with open(cg) as f:
                self.committed_gids = set(json.load(f))
        for fn in os.listdir(self.persist_dir):
            if fn.startswith("prepared-") and fn.endswith(".json"):
                with open(os.path.join(self.persist_dir, fn)) as f:
                    rec = json.load(f)
                self.prepared[rec["gid"]] = [tuple(op) for op in rec["ops"]]

    def _persist_committed(self):
        if not self.persist_dir:
            return
        cg = os.path.join(self.persist_dir, "committed-gids.json")
        tmp = cg + ".tmp"
        with open(tmp, "w") as f:
            json.dump(sorted(self.committed_gids), f)
        os.replace(tmp, cg)

    # -- transaction plumbing ----------------------------------------------
    def _apply_staged(self, staged: list) -> None:
        with self._lock:
            for op in staged:
                kind, table, cols, values, on_conflict = op
                t = self.tables.get(table)
                if t is None:
                    raise ValueError(f"relation {table} does not exist")
                t.insert(list(cols), [list(v) for v in values],
                         str(on_conflict))

    def _prepare(self, gid: str, staged: list) -> None:
        with self._lock:
            if gid in self.prepared:
                raise ValueError(f"transaction identifier {gid!r} is "
                                 "already in use")
            self.prepared[gid] = list(staged)
            if self.persist_dir:
                tmp = self._gid_path(gid) + ".tmp"
                with open(tmp, "w") as f:
                    json.dump({"gid": gid, "ops": self.prepared[gid]}, f)
                os.replace(tmp, self._gid_path(gid))

    def _validate_staged(self, staged: list) -> None:
        """Every failure ``insert`` could raise, checked BEFORE any row is
        applied — a failed COMMIT PREPARED must leave the txn prepared and
        the tables untouched (atomicity)."""
        pk_seen: Dict[str, set] = {}
        for op in staged:
            _kind, table, cols, values, on_conflict = op
            t = self.tables.get(table)
            if t is None:
                raise ValueError(f"relation {table} does not exist")
            missing = [c for c in cols if c not in t.columns]
            if missing:
                raise ValueError(f"column {missing[0]} does not exist")
            if t.pkey is not None and t.pkey in cols \
                    and on_conflict == "error":
                at = list(cols).index(t.pkey)
                seen = pk_seen.setdefault(table, set(t.pk_index))
                for row in values:
                    if row[at] in seen:
                        raise ValueError(
                            f"duplicate key value violates unique "
                            f"constraint on {t.pkey}")
                    seen.add(row[at])

    def _commit_prepared(self, gid: str) -> None:
        with self._lock:
            if gid in self.committed_gids:
                return  # idempotent replay (2PC restore path)
            staged = self.prepared.get(gid)
            if staged is None:
                raise ValueError(f"prepared transaction with identifier "
                                 f"{gid!r} does not exist")
            self._validate_staged(staged)
            self._apply_staged(staged)
            self.prepared.pop(gid)   # only after a fully successful apply
            self.committed_gids.add(gid)
            self._persist_committed()
            if self.persist_dir:
                try:
                    os.remove(self._gid_path(gid))
                except FileNotFoundError:
                    pass

    def _rollback_prepared(self, gid: str) -> None:
        with self._lock:
            if gid not in self.prepared:
                # real PostgreSQL rejects rollback of an unknown gid — the
                # restore path must enumerate pg_prepared_xacts, not probe
                raise ValueError(f"prepared transaction with identifier "
                                 f"{gid!r} does not exist")
            self.prepared.pop(gid)
            if self.persist_dir:
                try:
                    os.remove(self._gid_path(gid))
                except FileNotFoundError:
                    pass

    def list_prepared(self) -> List[str]:
        with self._lock:
            return sorted(self.prepared)

    # -- connection loop ----------------------------------------------------
    def _serve_conn(self, sock) -> None:
        (ln,) = struct.unpack(">i", _read_exact(sock, 4))
        payload = _read_exact(sock, ln - 4)
        (proto,) = struct.unpack(">i", payload[:4])
        if proto == 80877103:           # SSLRequest: politely decline
            sock.sendall(b"N")
            return self._serve_conn(sock)
        if proto != PROTOCOL_V3:
            sock.sendall(_error(f"unsupported protocol {proto}", "08P01"))
            return
        params: Dict[str, str] = {}
        parts = payload[4:].split(b"\0")
        for k, v in zip(parts[::2], parts[1::2]):
            if k:
                params[k.decode()] = v.decode()
        user = params.get("user", "")
        if self.users is not None:
            if self.auth == "scram-sha-256":
                if not self._scram_handshake(sock, user):
                    return
            else:
                salt = os.urandom(4)
                sock.sendall(_msg(b"R", struct.pack(">i", 5) + salt))
                t, body = read_message(sock)
                if t != b"p":
                    sock.sendall(_error("expected password message",
                                        "28000"))
                    return
                given = body.rstrip(b"\0").decode()
                want = self.users.get(user)
                if want is None or given != md5_password(user, want, salt):
                    sock.sendall(_error(
                        f'password authentication failed for user '
                        f'"{user}"', "28P01"))
                    return
        sock.sendall(_msg(b"R", struct.pack(">i", 0)))          # AuthOk
        self._post_auth(sock)
        txn = _TxnState()
        self._message_loop(sock, txn)

    def _scram_handshake(self, sock, user: str) -> bool:
        """SCRAM-SHA-256 (RFC 5802/7677, the PostgreSQL 10+ default):
        AuthenticationSASL → SASLInitialResponse → SASLContinue →
        client-final-with-proof → SASLFinal.  Mutual: the client proves
        the password via ClientProof, the server proves it KNOWS the
        password via ServerSignature.  Malformed client messages answer
        with an ErrorResponse, never a dropped socket."""
        try:
            return self._scram_handshake_inner(sock, user)
        except (KeyError, ValueError, IndexError, struct.error) as e:
            try:
                sock.sendall(_error(f"malformed SCRAM message: "
                                    f"{e or type(e).__name__}", "28000"))
            except OSError:
                pass
            return False

    def _scram_handshake_inner(self, sock, user: str) -> bool:
        from flink_tpu_torch.security.scram import ScramServer

        sock.sendall(_msg(b"R", struct.pack(">i", 10)
                          + _cstr("SCRAM-SHA-256") + b"\0"))
        t, body = read_message(sock)
        if t != b"p":
            sock.sendall(_error("expected SASLInitialResponse", "28000"))
            return False
        nul = body.index(b"\0")
        mech = body[:nul].decode()
        (ln,) = struct.unpack_from(">i", body, nul + 1)
        client_first = body[nul + 5:nul + 5 + ln].decode()
        if mech != "SCRAM-SHA-256":
            sock.sendall(_error(f"unsupported SASL mechanism {mech}",
                                "28000"))
            return False
        want = self.users.get(user)     # PG: the STARTUP user, not n=
        if want is None:
            sock.sendall(_error(
                f'password authentication failed for user "{user}"',
                "28P01"))
            return False
        scram = ScramServer()           # shared RFC 5802 math (security/)
        server_first = scram.first_response(client_first, want)
        sock.sendall(_msg(b"R", struct.pack(">i", 11)
                          + server_first.encode()))
        t, body = read_message(sock)
        if t != b"p":
            sock.sendall(_error("expected SASLResponse", "28000"))
            return False
        ok, final = scram.verify_final(body.decode())
        if not ok:
            sock.sendall(_error(
                f'password authentication failed for user "{user}"',
                "28P01"))
            return False
        sock.sendall(_msg(b"R", struct.pack(">i", 12) + final.encode()))
        return True

    def _post_auth(self, sock) -> None:
        for k, v in (("server_version", "14.0 (flink-tpu)"),
                     ("client_encoding", "UTF8")):
            sock.sendall(_msg(b"S", _cstr(k) + _cstr(v)))
        sock.sendall(_msg(b"K", struct.pack(">ii", os.getpid() & 0x7FFFFFFF,
                                            12345)))
        sock.sendall(_msg(b"Z", b"I"))

    def _message_loop(self, sock, txn) -> None:
        #: extended-protocol state (Parse/Bind/Describe/Execute/Sync —
        #: the JDBC-driver flow): prepared statements by name and bound
        #: portals (query + lazily cached result, so Describe's
        #: RowDescription and Execute's DataRows come from ONE evaluation)
        stmts: Dict[str, str] = {}
        portals: Dict[str, dict] = {}
        ext_out: List[bytes] = []
        aborted = [False]
        while True:
            t, body = read_message(sock)
            if t == b"X":
                return
            if t == b"Q":
                # a simple Query amid an extended batch acts as an
                # implicit Sync: buffered extended replies flush FIRST
                # (response order must match request order) and the
                # aborted state clears
                if ext_out:
                    sock.sendall(b"".join(ext_out))
                    ext_out.clear()
                aborted[0] = False
                sql = body.rstrip(b"\0").decode()
                out = []
                try:
                    for stmt in _split_statements(sql) or [""]:
                        tag, fields, rows = self._sql.execute(stmt, txn)
                        if tag == "EMPTY":
                            out.append(_msg(b"I", b""))
                            continue
                        if fields is not None:
                            out.append(_row_description(fields))
                            for r in rows:
                                out.append(_data_row(r))
                        out.append(_msg(b"C", _cstr(tag)))
                except (ValueError, TypeError, KeyError, IndexError) as e:
                    # every statement failure must surface as an 'E'
                    # message + ReadyForQuery, never kill the connection
                    out.append(_error(str(e) or type(e).__name__))
                    txn.reset()
                out.append(_msg(b"Z", b"T" if txn.explicit else b"I"))
                sock.sendall(b"".join(out))
            elif t in (b"P", b"B", b"D", b"E", b"C", b"H", b"S"):
                self._extended(t, body, txn, stmts, portals, ext_out,
                               aborted, sock)
            else:
                sock.sendall(_error(f"unsupported message {t!r}", "08P01"))
                sock.sendall(_msg(b"Z", b"I"))

    def _extended(self, t: bytes, body: bytes, txn, stmts, portals,
                  out: List[bytes], aborted: List[bool], sock) -> None:
        """One extended-protocol message.  Responses buffer until Sync or
        Flush; an error puts the connection in the aborted state, where
        everything but Sync is skipped (the reference's
        skip-till-sync)."""
        if t == b"S":                        # Sync: flush + ReadyForQuery
            out.append(_msg(b"Z", b"T" if txn.explicit else b"I"))
            sock.sendall(b"".join(out))
            out.clear()
            aborted[0] = False
            return
        if t == b"H":                        # Flush
            sock.sendall(b"".join(out))
            out.clear()
            return
        if aborted[0]:
            return
        try:
            if t == b"P":                    # Parse
                nul1 = body.index(b"\0")
                name = body[:nul1].decode()
                nul2 = body.index(b"\0", nul1 + 1)
                stmts[name] = body[nul1 + 1:nul2].decode()
                out.append(_msg(b"1", b""))
            elif t == b"B":                  # Bind
                pos = body.index(b"\0")
                portal = body[:pos].decode()
                pos += 1
                end = body.index(b"\0", pos)
                stmt_name = body[pos:end].decode()
                pos = end + 1
                (nfmt,) = struct.unpack_from(">h", body, pos)
                pos += 2
                fmts = struct.unpack_from(f">{nfmt}h", body, pos) \
                    if nfmt else ()
                pos += 2 * nfmt
                if any(f == 1 for f in fmts):
                    # binary-format parameters would be misread as UTF-8
                    # text: reject explicitly rather than corrupt
                    raise ValueError("binary-format parameters are not "
                                     "supported (send text format)")
                (nparams,) = struct.unpack_from(">h", body, pos)
                pos += 2
                params: List[Optional[str]] = []
                for _ in range(nparams):
                    (ln,) = struct.unpack_from(">i", body, pos)
                    pos += 4
                    if ln < 0:
                        params.append(None)
                    else:
                        params.append(body[pos:pos + ln].decode())
                        pos += ln
                (nrfmt,) = struct.unpack_from(">h", body, pos)
                rfmts = struct.unpack_from(f">{nrfmt}h", body, pos + 2) \
                    if nrfmt else ()
                if any(f == 1 for f in rfmts):
                    raise ValueError("binary result format is not "
                                     "supported (request text format)")
                if stmt_name not in stmts:
                    raise ValueError(f"unknown prepared statement "
                                     f"{stmt_name!r}")
                portals[portal] = {
                    "query": _substitute_params(stmts[stmt_name], params)}
                out.append(_msg(b"2", b""))
            elif t == b"D":                  # Describe
                kind, name = chr(body[0]), body[1:].rstrip(b"\0").decode()
                if kind == "P":
                    p = portals.get(name)
                    if p is None:
                        raise ValueError(f"unknown portal {name!r}")
                    self._run_portal(p, txn)
                    out.append(_row_description(p["fields"])
                               if p["fields"] is not None
                               else _msg(b"n", b""))
                else:                        # statement: no param typing
                    out.append(_msg(b"n", b""))
            elif t == b"E":                  # Execute
                name = body[:body.index(b"\0")].decode()
                p = portals.get(name)
                if p is None:
                    raise ValueError(f"unknown portal {name!r}")
                self._run_portal(p, txn)
                if p["tag"] == "EMPTY":
                    out.append(_msg(b"I", b""))
                else:
                    for r in (p["rows"] or []):
                        out.append(_data_row(r))
                    out.append(_msg(b"C", _cstr(p["tag"])))
            elif t == b"C":                  # Close statement/portal
                kind, name = chr(body[0]), body[1:].rstrip(b"\0").decode()
                (stmts if kind == "S" else portals).pop(name, None)
                out.append(_msg(b"3", b""))
        except (ValueError, TypeError, KeyError, IndexError,
                struct.error) as e:
            out.append(_error(str(e) or type(e).__name__))
            aborted[0] = True
            txn.reset()

    def _run_portal(self, p: dict, txn) -> None:
        """Evaluate the portal's query ONCE; Describe and Execute share
        the result (the reference derives Describe metadata without
        executing; the mini engine evaluates eagerly instead)."""
        if "tag" not in p:
            tag, fields, rows = self._sql.execute(p["query"], txn)
            p["tag"], p["fields"], p["rows"] = tag, fields, rows

    def close(self):
        stop_serving(self._tcp, self._thread)


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class PostgresError(Exception):
    def __init__(self, fields: Dict[str, str]):
        self.fields = fields
        super().__init__(fields.get("M", "postgres error"))


class PostgresWireClient:
    """Minimal v3 frontend: startup + trust/md5 auth + simple query."""

    def __init__(self, host: str, port: int, user: str = "flink",
                 password: str = "", database: str = "flink",
                 timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        try:
            payload = struct.pack(">i", PROTOCOL_V3) + _cstr("user") \
                + _cstr(user) + _cstr("database") + _cstr(database) + b"\0"
            self.sock.sendall(struct.pack(">i", len(payload) + 4) + payload)
            self.parameters: Dict[str, str] = {}
            scram: Dict[str, Any] = {}
            while True:
                t, body = read_message(self.sock)
                if t == b"R":
                    (code,) = struct.unpack(">i", body[:4])
                    if code == 0:
                        continue
                    if code == 5:
                        pw = md5_password(user, password, body[4:8])
                        self.sock.sendall(_msg(b"p", _cstr(pw)))
                        continue
                    if code in (10, 11, 12):
                        self._scram_step(code, body[4:], user, password,
                                         scram)
                        continue
                    raise PostgresError(
                        {"M": f"unsupported auth code {code}"})
                if t == b"S":
                    k, v = body.split(b"\0")[:2]
                    self.parameters[k.decode()] = v.decode()
                elif t == b"E":
                    raise PostgresError(self._error_fields(body))
                elif t == b"Z":
                    return
                # 'K' BackendKeyData and anything else: informational
        except BaseException:
            # a failed handshake (auth rejection, protocol error) must not
            # leak the connected socket — repeated failed connects would
            # accumulate open FDs
            self.sock.close()
            raise

    def _scram_step(self, code: int, payload: bytes, user: str,
                    password: str, st: Dict[str, Any]) -> None:
        """Client half of SCRAM-SHA-256 over the PG SASL framing (auth
        codes 10/11/12), delegating the RFC 5802 math to the shared
        ``flink_tpu_torch.security.scram`` implementation.  Mutual: the final
        step verifies the SERVER's signature."""
        from flink_tpu_torch.security.scram import ScramClient

        if code == 10:                       # AuthenticationSASL
            mechs = [m.decode() for m in payload.split(b"\0") if m]
            if "SCRAM-SHA-256" not in mechs:
                raise PostgresError({"M": f"no usable SASL mechanism "
                                          f"in {mechs}"})
            # PG convention: the SCRAM username is empty (the startup
            # packet already named the user)
            st["scram"] = sc = ScramClient("", password)
            first = sc.first()
            self.sock.sendall(_msg(
                b"p", _cstr("SCRAM-SHA-256")
                + struct.pack(">i", len(first)) + first.encode()))
        elif code == 11:                     # SASLContinue (server-first)
            try:
                final = st["scram"].final(payload.decode())
            except ValueError as e:
                raise PostgresError({"M": str(e)}) from e
            self.sock.sendall(_msg(b"p", final.encode()))
        else:                                # SASLFinal: verify the server
            try:
                st["scram"].verify(payload.decode())
            except ValueError as e:
                raise PostgresError({"M": str(e)}) from e

    @staticmethod
    def _error_fields(body: bytes) -> Dict[str, str]:
        out = {}
        for part in body.split(b"\0"):
            if part:
                out[chr(part[0])] = part[1:].decode()
        return out

    def query(self, sql: str
              ) -> Tuple[List[Tuple[str, int]], List[List[Optional[str]]]]:
        """Simple-query cycle: returns (fields as (name, oid), text rows).
        Statements without a result set return ([], [])."""
        self.sock.sendall(_msg(b"Q", _cstr(sql)))
        return self._read_until_ready()

    def _read_until_ready(self) -> Tuple[List[Tuple[str, int]],
                                         List[List[Optional[str]]]]:
        """Drain responses to ReadyForQuery — shared by the simple AND
        extended query cycles (extended-only messages like ParseComplete
        fall through like CommandComplete does)."""
        fields: List[Tuple[str, int]] = []
        rows: List[List[Optional[str]]] = []
        err: Optional[Dict[str, str]] = None
        while True:
            t, body = read_message(self.sock)
            if t == b"T":
                (n,) = struct.unpack(">h", body[:2])
                off = 2
                fields = []
                rows = []   # a new result set replaces any earlier one
                for _ in range(n):
                    end = body.index(b"\0", off)
                    name = body[off:end].decode()
                    off = end + 1
                    (_tab, _att, oid, _tl, _tm, _fmt) = struct.unpack(
                        ">ihihih", body[off:off + 18])
                    off += 18
                    fields.append((name, oid))
            elif t == b"D":
                (n,) = struct.unpack(">h", body[:2])
                off = 2
                row: List[Optional[str]] = []
                for _ in range(n):
                    (ln,) = struct.unpack(">i", body[off:off + 4])
                    off += 4
                    if ln == -1:
                        row.append(None)
                    else:
                        row.append(body[off:off + ln].decode())
                        off += ln
                rows.append(row)
            elif t == b"E":
                err = self._error_fields(body)
            elif t == b"Z":
                if err is not None:
                    raise PostgresError(err)
                return fields, rows
            # 'C' CommandComplete / 'I' Empty / 'N' Notice / '1' Parse-
            # Complete / '2' BindComplete / 'n' NoData / '3' Close-
            # Complete: fall through

    @staticmethod
    def _typed_columns(fields, rows) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for j, (name, oid) in enumerate(fields):
            dt = _OID_DTYPE.get(oid, np.dtype(object))
            vals = [_parse_cell(r[j], dt) for r in rows]
            if any(v is None for v in vals):
                dt = np.dtype(object)
            out[name] = np.asarray(vals, dtype=dt)
        return out

    def query_columns(self, sql: str) -> Dict[str, np.ndarray]:
        """Typed columns (numpy, dtype from the field OIDs)."""
        return self._typed_columns(*self.query(sql))

    def execute(self, sql: str) -> None:
        self.query(sql)

    def execute_prepared(self, sql: str, params: Sequence[Any] = ()
                         ) -> Tuple[List[Tuple[str, int]],
                                    List[List[Optional[str]]]]:
        """EXTENDED-protocol cycle (the JDBC PreparedStatement flow):
        Parse → Bind (text-format ``$n`` parameters) → Describe(portal) →
        Execute → Sync; returns (fields, text rows)."""
        def enc(v: Any) -> Optional[bytes]:
            if v is None:
                return None
            if isinstance(v, (bool, np.bool_)):
                return b"true" if v else b"false"
            return str(v).encode()

        parse = _cstr("") + _cstr(sql) + struct.pack(">h", 0)
        bind = bytearray(_cstr("") + _cstr("") + struct.pack(">h", 0))
        bind += struct.pack(">h", len(params))
        for v in params:
            b = enc(v)
            if b is None:
                bind += struct.pack(">i", -1)
            else:
                bind += struct.pack(">i", len(b)) + b
        bind += struct.pack(">h", 0)
        frames = (_msg(b"P", parse) + _msg(b"B", bytes(bind))
                  + _msg(b"D", b"P\0") + _msg(b"E", _cstr("")
                                              + struct.pack(">i", 0))
                  + _msg(b"S", b""))
        self.sock.sendall(frames)
        return self._read_until_ready()

    def query_prepared(self, sql: str, params: Sequence[Any] = ()
                       ) -> Dict[str, np.ndarray]:
        """Typed columns via the extended protocol (``query_columns``'s
        prepared-statement twin)."""
        return self._typed_columns(*self.execute_prepared(sql, params))

    def close(self):
        try:
            self.sock.sendall(_msg(b"X", b""))
        except OSError:
            pass
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# connector seams
# ---------------------------------------------------------------------------


_NUM_INT = re.compile(r"[+-]?\d+$")
_NUM_FLOAT = re.compile(r"[+-]?(\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?$")


def _substitute_params(query: str, params: List[Optional[str]]) -> str:
    """Extended-protocol Bind: inline text-format parameters for ``$n``
    placeholders OUTSIDE string literals (the mini engine evaluates SQL
    text; a full server binds into a parse tree).  Values quote as typed
    literals — strictly numeric text stays bare (``1_0``/``infinity``
    spellings that Python's int()/float() accept do NOT count), anything
    else single-quotes."""
    def lit(v: Optional[str]) -> str:
        if v is None:
            return "NULL"
        if _NUM_INT.fullmatch(v) or _NUM_FLOAT.fullmatch(v):
            return v
        if v.lower() in ("true", "false"):
            return v
        return "'" + v.replace("'", "''") + "'"

    out: List[str] = []
    i, n = 0, len(query)
    in_str = False
    while i < n:
        ch = query[i]
        if ch == "'":
            in_str = not in_str
            out.append(ch)
            i += 1
        elif ch == "$" and not in_str and i + 1 < n \
                and query[i + 1].isdigit():
            j = i + 1
            while j < n and query[j].isdigit():
                j += 1
            idx = int(query[i + 1:j]) - 1
            if not 0 <= idx < len(params):
                raise ValueError(f"parameter ${query[i + 1:j]} not bound")
            out.append(lit(params[idx]))
            i = j
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _sql_literal(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, (bool, np.bool_)):
        return "TRUE" if v else "FALSE"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return "'" + str(v).replace("'", "''") + "'"


@dataclass
class PostgresSplit(SourceSplit):
    lo: Any = None                     # inclusive lower bound
    hi: Any = None                     # upper bound on partition_column
    hi_inclusive: bool = True          # last split closes the range

    def split_id(self) -> str:
        return f"pg:{self.lo}..{self.hi}{'i' if self.hi_inclusive else ''}"

    def read(self) -> Iterator[StreamElement]:
        return self.source.open_split(self, None)


class _PositionedPgReader:
    """Iterator over one split's batches; ``position`` = rows already
    emitted within the split's ordered range scan, so checkpoints resume
    mid-split (the repo-wide positioned-reader seam, file_source.py)."""

    def __init__(self, source: "PostgresSource", split: PostgresSplit,
                 start_row: int):
        self.position = int(start_row)
        self._it = source._read_range(split.lo, split.hi,
                                      split.hi_inclusive, self.position)

    def __iter__(self):
        return self

    def __next__(self) -> StreamElement:
        el = next(self._it)
        if isinstance(el, RecordBatch):
            self.position += len(el)
        return el


class PostgresSource(Source):
    """Bounded partitioned table scan (``JdbcRowDataInputFormat`` +
    ``JdbcNumericBetweenParametersProvider.java:42`` analog): splits are
    equal numeric ranges of ``partition_column`` between its MIN and MAX,
    each read as an ordered range SELECT."""

    def __init__(self, host: str, port: int, table: str,
                 partition_column: str, columns: Optional[List[str]] = None,
                 num_splits: int = 0, batch_size: int = 4096,
                 user: str = "flink", password: str = "",
                 timestamp_column: Optional[str] = None):
        self.host, self.port = host, port
        self.table = table
        self.partition_column = partition_column
        self.columns = columns
        self.num_splits = num_splits
        self.batch_size = batch_size
        self.user, self.password = user, password
        self.timestamp_column = timestamp_column

    def _connect(self) -> PostgresWireClient:
        return PostgresWireClient(self.host, self.port, user=self.user,
                                  password=self.password)

    def create_splits(self, parallelism: int) -> List[PostgresSplit]:
        n = self.num_splits or parallelism
        with self._connect() as c:
            cols = c.query_columns(
                f"SELECT MIN({self.partition_column}), "
                f"MAX({self.partition_column}), COUNT(*) FROM {self.table}")
        if int(cols["count"][0]) == 0 or cols["min"][0] is None:
            return []
        lo_v, hi_v = cols["min"][0], cols["max"][0]
        n = max(1, n)
        if hi_v <= lo_v:
            return [PostgresSplit(self, 0, 1, lo=lo_v, hi=hi_v,
                                  hi_inclusive=True)]
        if isinstance(lo_v, (int, np.integer)) \
                and isinstance(hi_v, (int, np.integer)):
            # exact integer arithmetic (JdbcNumericBetweenParametersProvider):
            # float() rounding of int8 values beyond 2^53 can push the lower
            # bound above the true MIN and drop boundary rows from every split
            # (Python ints: np.int64 would overflow on span * i)
            lo_i, hi_i = int(lo_v), int(hi_v)
            span = hi_i - lo_i + 1
            bounds = [lo_i + span * i // n for i in range(n)] + [hi_i]
        else:
            lo, hi = float(lo_v), float(hi_v)
            # HALF-OPEN real-valued boundaries [b_i, b_{i+1}) and a closed
            # last split — integer-rounded inclusive ranges would silently
            # drop fractional values falling between splits
            bounds = [lo + (hi - lo) * i / n for i in range(n)] + [hi]
        splits = []
        for i in range(n):
            splits.append(PostgresSplit(
                self, i, n, lo=bounds[i], hi=bounds[i + 1],
                hi_inclusive=(i == n - 1)))
        return splits

    def open_split(self, split: PostgresSplit,
                   position: Optional[int]) -> _PositionedPgReader:
        return _PositionedPgReader(self, split, position or 0)

    def _read_range(self, lo, hi, hi_inclusive: bool,
                    skip: int) -> Iterator[StreamElement]:
        proj = ", ".join(self.columns) if self.columns else "*"
        hi_op = "<=" if hi_inclusive else "<"
        with self._connect() as c:
            cols = c.query_columns(
                f"SELECT {proj} FROM {self.table} "
                f"WHERE {self.partition_column} >= {_sql_literal(lo)} "
                f"AND {self.partition_column} {hi_op} {_sql_literal(hi)} "
                f"ORDER BY {self.partition_column}")
        n = 0
        for v in cols.values():
            n = len(v)
            break
        for start in range(skip, n, self.batch_size):
            stop = min(start + self.batch_size, n)
            chunk = {k: v[start:stop] for k, v in cols.items()}
            ts = (np.asarray(chunk[self.timestamp_column], np.int64)
                  if self.timestamp_column else None)
            yield RecordBatch(chunk, timestamps=ts)


class PostgresLookupFunction:
    """Dimension point-lookup against a PostgreSQL server over the wire —
    the ``JdbcRowDataLookupFunction`` analog feeding the SQL layer's
    ``LookupJoinOperator`` (register via
    ``TableEnvironment.register_lookup_table(name, fn, columns,
    key_column)``).  One connection, lazily opened, re-opened on error;
    caching lives in the operator, not here."""

    def __init__(self, host: str, port: int, table: str, key_column: str,
                 columns: Optional[List[str]] = None,
                 user: str = "flink", password: str = ""):
        self.host, self.port = host, port
        self.table = table
        self.key_column = key_column
        self.columns = columns
        self.user, self.password = user, password
        self._conn: Optional[PostgresWireClient] = None

    def _client(self) -> PostgresWireClient:
        if self._conn is None:
            self._conn = PostgresWireClient(self.host, self.port,
                                            user=self.user,
                                            password=self.password)
        return self._conn

    def __call__(self, key) -> List[dict]:
        proj = ", ".join(self.columns) if self.columns else "*"
        sql = (f"SELECT {proj} FROM {self.table} "
               f"WHERE {self.key_column} = {_sql_literal(key)}")
        try:
            cols = self._client().query_columns(sql)
        except (OSError, PostgresError):
            # dropped connection: one reconnect-and-retry
            self.close()
            cols = self._client().query_columns(sql)
        names = list(cols)
        n = len(cols[names[0]]) if names else 0
        return [{c: cols[c][i] for c in names} for i in range(n)]

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None


class PostgresSink(Sink):
    """Buffered relational sink (``JdbcSink.sink`` /
    ``JdbcBatchingOutputFormat`` analog).

    - ``exactly_once=False``: multi-row INSERTs flushed by buffer size and
      on checkpoint (``snapshot_state`` flushes; at-least-once, and
      idempotent end-to-end when ``upsert`` targets a primary key — the
      reference ships the same two delivery shapes).
    - ``exactly_once=True``: rows buffer into an explicit transaction,
      ``snapshot_state`` flushes and stages it as ``PREPARE TRANSACTION``
      bound to the checkpoint epoch; ``notify_checkpoint_complete``
      issues ``COMMIT PREPARED`` (idempotent server-side), and restore
      re-commits the snapshot's staged gids then rolls back any other
      dangling gid of this sink — the XA pattern of
      ``JdbcXaSinkFunction.java`` on PostgreSQL-native 2PC.
    """

    #: each parallel subtask needs its OWN buffers and txn identity
    clone_per_subtask = True

    def __init__(self, host: str, port: int, table: str,
                 columns: List[str], upsert: bool = False,
                 conflict_column: Optional[str] = None,
                 exactly_once: bool = False, buffer_rows: int = 4096,
                 user: str = "flink", password: str = "",
                 sink_id: str = "pg-sink"):
        self.host, self.port = host, port
        self.table = table
        self.columns = list(columns)
        self.upsert = upsert
        #: upsert conflict target (the table's primary key); defaults to
        #: the first sink column
        self.conflict_column = conflict_column or self.columns[0]
        self.exactly_once = exactly_once
        self.buffer_rows = buffer_rows
        self.user, self.password = user, password
        self.sink_id = sink_id
        self._subtask_index = 0
        self._buf: List[list] = []
        self._conn: Optional[PostgresWireClient] = None
        self._epoch = 0               # staged-transaction counter
        #: gids prepared but not yet committed, each bound to the
        #: checkpoint id whose snapshot staged it (None = runtime gave no
        #: id; the legacy notify-before-next-barrier ordering applies)
        self._staged: List[Tuple[str, Optional[int]]] = []
        self._in_txn = False

    def on_cloned(self) -> None:
        self._conn = None             # never share a socket across subtasks

    def open(self, ctx) -> None:
        self._subtask_index = getattr(ctx, "subtask_index", 0)

    # -- plumbing -----------------------------------------------------------
    def _client(self) -> PostgresWireClient:
        if self._conn is None:
            self._conn = PostgresWireClient(self.host, self.port,
                                            user=self.user,
                                            password=self.password)
        return self._conn

    def _gid(self, epoch: int) -> str:
        return f"{self.sink_id}-s{self._subtask_index}-{epoch}"

    def _insert_sql(self, rows: List[list]) -> str:
        vals = ", ".join(
            "(" + ", ".join(_sql_literal(v) for v in row) + ")"
            for row in rows)
        sql = (f"INSERT INTO {self.table} ({', '.join(self.columns)}) "
               f"VALUES {vals}")
        if self.upsert:
            # the full PostgreSQL form — valid against real servers too
            sets = ", ".join(f"{c} = EXCLUDED.{c}" for c in self.columns
                             if c != self.conflict_column)
            sql += (f" ON CONFLICT ({self.conflict_column}) DO UPDATE "
                    f"SET {sets}")
        return sql

    def _flush_buffer(self) -> None:
        if not self._buf:
            return
        c = self._client()
        if self.exactly_once and not self._in_txn:
            c.execute("BEGIN")
            self._in_txn = True
        for lo in range(0, len(self._buf), self.buffer_rows):
            c.execute(self._insert_sql(self._buf[lo:lo + self.buffer_rows]))
        self._buf = []

    # -- Sink contract ------------------------------------------------------
    def write_batch(self, batch: RecordBatch) -> None:
        cols = [np.asarray(batch.column(c)) for c in self.columns]
        for i in range(len(batch)):
            self._buf.append([c[i] for c in cols])
        if not self.exactly_once and len(self._buf) >= self.buffer_rows:
            self._flush_buffer()

    def flush(self) -> None:
        """End-of-input: at-least-once flushes the buffer; exactly-once
        stages and commits the final epoch (input is exhausted — there is
        no later checkpoint left to bind it to)."""
        self._flush_buffer()
        if self.exactly_once and self._in_txn:
            gid = self._gid(self._epoch)
            c = self._client()
            c.execute(f"PREPARE TRANSACTION '{gid}'")
            c.execute(f"COMMIT PREPARED '{gid}'")
            self._in_txn = False
            self._epoch += 1

    def snapshot_state(self) -> Dict[str, Any]:
        from flink_tpu_torch.operators.base import current_checkpoint_id

        self._flush_buffer()
        if self.exactly_once and self._in_txn:
            gid = self._gid(self._epoch)
            self._client().execute(f"PREPARE TRANSACTION '{gid}'")
            self._staged.append((gid, current_checkpoint_id()))
            self._in_txn = False
            self._epoch += 1
        return {"epoch": self._epoch, "staged": list(self._staged)}

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        """Commit ONLY gids staged for checkpoints <= the notified one
        (TwoPhaseCommitSinkFunction contract, same as log_service.py):
        if checkpoints ever pipeline, an epoch staged for a later,
        uncompleted checkpoint must not commit early — a restore to this
        checkpoint would replay its rows and duplicate them."""
        if not self.exactly_once:
            return
        c = self._client()
        keep = []
        for gid, staged_for in self._staged:
            if staged_for is not None and staged_for > checkpoint_id:
                keep.append((gid, staged_for))
                continue
            c.execute(f"COMMIT PREPARED '{gid}'")
        self._staged = keep

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self._epoch = int(snap.get("epoch", 0))
        self._buf = []
        self._in_txn = False
        c = self._client()
        # commit the snapshot's staged epochs (their rows are part of the
        # restored checkpoint; COMMIT PREPARED replays idempotently), then
        # abort every OTHER dangling prepared txn of this sink — epochs
        # staged after the restored checkpoint must not surface later.
        # The dangling set is enumerated from pg_prepared_xacts (a real-PG
        # catalog view), not probed by gid range: a restore arbitrarily far
        # behind the crash still finds every orphan, and ROLLBACK PREPARED
        # is only ever issued for gids that actually exist
        committed = set()
        for entry in snap.get("staged", []):
            gid = entry[0] if isinstance(entry, (tuple, list)) else entry
            c.execute(f"COMMIT PREPARED '{gid}'")
            committed.add(gid)
        self._staged = []
        mine = f"{self.sink_id}-s{self._subtask_index}-"
        dangling = c.query_columns("SELECT gid FROM pg_prepared_xacts")
        for gid in dangling.get("gid", []):
            if gid is None or not gid.startswith(mine) or gid in committed:
                continue
            try:
                c.execute(f"ROLLBACK PREPARED '{gid}'")
            except PostgresError:
                pass  # raced with another recovering instance: already gone

    def close(self) -> None:
        if self.exactly_once and self._in_txn and self._conn is not None:
            try:
                self._conn.execute("ROLLBACK")
            except (PostgresError, OSError):
                pass
            self._in_txn = False
        elif not self.exactly_once:
            try:
                self._flush_buffer()
            except (PostgresError, OSError):
                pass
        if self._conn is not None:
            self._conn.close()
            self._conn = None

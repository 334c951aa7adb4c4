"""Cassandra connector: CQL binary protocol v4 server, client, and sink.

The port's copy of ``flink_tpu/connectors/cassandra.py``: host Python as
JAX's, the same bytes on the wire and on disk, so either package's client
talks to the other's server.

Analog of ``flink-connectors/flink-connector-cassandra``
(``CassandraSink`` / ``CassandraRowOutputFormat``): rows write as
INSERTs (at-least-once, flush-on-checkpoint; Cassandra upserts by
primary key, so deterministic keys make replays idempotent — the same
recipe the reference documents), and a bounded source scans a table.

The wire dialect is the real CQL native protocol v4 on both sides:
9-byte frame header (version/flags/stream/opcode/length), STARTUP →
READY handshake, QUERY with consistency + flags, RESULT kinds (VOID /
ROWS with global-table-spec metadata / SET_KEYSPACE), ERROR frames.
Values ride the v4 type codec for the types the connector uses
(bigint/int/double/float/boolean/varchar).  ``CqlServer`` keeps
keyspaces of primary-keyed tables and evaluates the CQL subset the
connector emits (CREATE KEYSPACE/TABLE, INSERT, SELECT with WHERE on
the partition key, USE); a conforming driver can complete the same
handshake and query cycle.
"""

from __future__ import annotations

import re
import socket
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.utils.servers import ConnectionThreads

# opcodes
OP_ERROR, OP_STARTUP, OP_READY = 0x00, 0x01, 0x02
OP_OPTIONS, OP_SUPPORTED = 0x05, 0x06
OP_QUERY, OP_RESULT = 0x07, 0x08

RESULT_VOID, RESULT_ROWS, RESULT_SET_KEYSPACE = 0x0001, 0x0002, 0x0003

# CQL type ids (v4 option codes)
T_VARCHAR, T_BIGINT, T_BOOLEAN, T_DOUBLE, T_FLOAT, T_INT = \
    0x0D, 0x02, 0x04, 0x07, 0x08, 0x09

_CQL_TYPES = {
    "text": T_VARCHAR, "varchar": T_VARCHAR, "bigint": T_BIGINT,
    "boolean": T_BOOLEAN, "double": T_DOUBLE, "float": T_FLOAT,
    "int": T_INT,
}


class CassandraError(Exception):
    pass


# ---------------------------------------------------------------------------
# value codec (v4 [bytes] values)
# ---------------------------------------------------------------------------


def _enc_value(type_id: int, v: Any) -> Optional[bytes]:
    if v is None:
        return None
    if type_id == T_VARCHAR:
        return str(v).encode()
    if type_id == T_BIGINT:
        return struct.pack(">q", int(v))
    if type_id == T_INT:
        return struct.pack(">i", int(v))
    if type_id == T_DOUBLE:
        return struct.pack(">d", float(v))
    if type_id == T_FLOAT:
        return struct.pack(">f", float(v))
    if type_id == T_BOOLEAN:
        return b"\x01" if v else b"\x00"
    raise CassandraError(f"unsupported type id {type_id}")


def _dec_value(type_id: int, b: Optional[bytes]) -> Any:
    if b is None:
        return None
    if type_id == T_VARCHAR:
        return b.decode()
    if type_id == T_BIGINT:
        return struct.unpack(">q", b)[0]
    if type_id == T_INT:
        return struct.unpack(">i", b)[0]
    if type_id == T_DOUBLE:
        return struct.unpack(">d", b)[0]
    if type_id == T_FLOAT:
        return struct.unpack(">f", b)[0]
    if type_id == T_BOOLEAN:
        return b != b"\x00"
    raise CassandraError(f"unsupported type id {type_id}")


def _string(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


def _long_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">I", len(b)) + b


def _read_string(data: bytes, pos: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from(">H", data, pos)
    return data[pos + 2:pos + 2 + n].decode(), pos + 2 + n


def _bytes_val(b: Optional[bytes]) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


def _frame(version: int, stream: int, opcode: int, body: bytes) -> bytes:
    return struct.pack(">BBhBI", version, 0, stream, opcode,
                       len(body)) + body


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _read_frame(sock) -> Optional[Tuple[int, int, int, bytes]]:
    hdr = _recv_exact(sock, 9)
    if hdr is None:
        return None
    version, _flags, stream, opcode, length = struct.unpack(">BBhBI", hdr)
    body = _recv_exact(sock, length) if length else b""
    if length and body is None:
        return None
    return version, stream, opcode, body


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class _CqlTable:
    def __init__(self, columns: List[str], types: List[str], pkey: str):
        self.columns = columns
        self.types = types
        self.pkey = pkey
        self.rows: Dict[Any, List[Any]] = {}   # pk -> row values (UPSERT)

    def type_ids(self) -> List[int]:
        return [_CQL_TYPES[t] for t in self.types]


class CqlServer:
    """Single-node CQL v4 server: keyspaces of primary-keyed tables."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._lock = threading.Lock()
        self.keyspaces: Dict[str, Dict[str, _CqlTable]] = {}
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()[:2]
        self._stop = threading.Event()
        self._connections = ConnectionThreads("cql-server")
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="cql-server")
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        self._thread.join()
        try:
            self._srv.close()
        except OSError:
            pass
        self._connections.close()

    def _accept_loop(self) -> None:
        self._srv.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self._connections.start(self._serve, conn)

    def _serve(self, sock: socket.socket) -> None:
        keyspace = [None]
        try:
            while True:
                fr = _read_frame(sock)
                if fr is None:
                    return
                version, stream, opcode, body = fr
                resp_v = version | 0x80           # response direction bit
                if opcode == OP_OPTIONS:
                    # string multimap of supported options
                    sup = struct.pack(">H", 1) + _string("CQL_VERSION") \
                        + struct.pack(">H", 1) + _string("3.4.4")
                    sock.sendall(_frame(resp_v, stream, OP_SUPPORTED, sup))
                elif opcode == OP_STARTUP:
                    sock.sendall(_frame(resp_v, stream, OP_READY, b""))
                elif opcode == OP_QUERY:
                    (qlen,) = struct.unpack_from(">I", body, 0)
                    cql = body[4:4 + qlen].decode()
                    try:
                        resp = self._execute(cql, keyspace)
                    except CassandraError as e:
                        err = struct.pack(">i", 0x2200) + _string(str(e))
                        sock.sendall(_frame(resp_v, stream, OP_ERROR, err))
                        continue
                    except (ValueError, KeyError, IndexError,
                            TypeError) as e:
                        # malformed literals/columns surface as a
                        # recoverable ERROR frame — the CONNECTION must
                        # survive a bad query, as real Cassandra's does
                        err = struct.pack(">i", 0x2000) \
                            + _string(str(e) or type(e).__name__)
                        sock.sendall(_frame(resp_v, stream, OP_ERROR, err))
                        continue
                    sock.sendall(_frame(resp_v, stream, OP_RESULT, resp))
                else:
                    err = struct.pack(">i", 0x000A) \
                        + _string(f"unsupported opcode {opcode}")
                    sock.sendall(_frame(resp_v, stream, OP_ERROR, err))
        except (OSError, struct.error):
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    # -- CQL evaluation -----------------------------------------------------
    def _execute(self, cql: str, keyspace: List[Optional[str]]) -> bytes:
        s = cql.strip().rstrip(";").strip()
        up = s.upper()
        if up.startswith("CREATE KEYSPACE"):
            m = re.match(r"CREATE\s+KEYSPACE\s+(IF\s+NOT\s+EXISTS\s+)?"
                         r"(\w+)", s, re.I)
            if not m:
                raise CassandraError("malformed CREATE KEYSPACE")
            with self._lock:
                self.keyspaces.setdefault(m.group(2).lower(), {})
            return struct.pack(">i", RESULT_VOID)
        if up.startswith("USE "):
            name = s[4:].strip().lower()
            with self._lock:
                if name not in self.keyspaces:
                    raise CassandraError(f"keyspace {name} does not exist")
            keyspace[0] = name
            return struct.pack(">i", RESULT_SET_KEYSPACE) + _string(name)
        if up.startswith("CREATE TABLE"):
            return self._create_table(s, keyspace)
        if up.startswith("INSERT"):
            return self._insert(s, keyspace)
        if up.startswith("SELECT"):
            return self._select(s, keyspace)
        raise CassandraError(f"unsupported statement: {s.split()[0]}")

    def _resolve(self, name: str, keyspace) -> Tuple[str, str]:
        if "." in name:
            ks, _, t = name.partition(".")
            return ks.lower(), t.lower()
        if keyspace[0] is None:
            raise CassandraError("no keyspace selected")
        return keyspace[0], name.lower()

    def _table(self, name: str, keyspace) -> _CqlTable:
        ks, t = self._resolve(name, keyspace)
        with self._lock:
            tbl = self.keyspaces.get(ks, {}).get(t)
        if tbl is None:
            raise CassandraError(f"table {ks}.{t} does not exist")
        return tbl

    def _create_table(self, s: str, keyspace) -> bytes:
        m = re.match(r"CREATE\s+TABLE\s+(IF\s+NOT\s+EXISTS\s+)?([\w.]+)"
                     r"\s*\((.*)\)$", s, re.I | re.S)
        if not m:
            raise CassandraError("malformed CREATE TABLE")
        ks, t = self._resolve(m.group(2), keyspace)
        cols, types, pkey = [], [], None
        for part in m.group(3).split(","):
            part = part.strip()
            pm = re.match(r"PRIMARY\s+KEY\s*\(\s*(\w+)\s*\)", part, re.I)
            if pm:
                pkey = pm.group(1).lower()
                continue
            cm = re.match(r"(\w+)\s+(\w+)(\s+PRIMARY\s+KEY)?$", part, re.I)
            if not cm:
                raise CassandraError(f"malformed column def {part!r}")
            cname, ctype = cm.group(1).lower(), cm.group(2).lower()
            if ctype not in _CQL_TYPES:
                raise CassandraError(f"unsupported type {ctype!r}")
            cols.append(cname)
            types.append(ctype)
            if cm.group(3):
                pkey = cname
        if pkey is None:
            raise CassandraError("a PRIMARY KEY is required")
        with self._lock:
            self.keyspaces.setdefault(ks, {})
            if t in self.keyspaces[ks]:
                if m.group(1):           # IF NOT EXISTS: keep the table
                    return struct.pack(">i", RESULT_VOID)
                # real Cassandra raises AlreadyExists — silently replacing
                # would wipe stored rows a restarted job depends on
                raise CassandraError(f"table {ks}.{t} already exists")
            self.keyspaces[ks][t] = _CqlTable(cols, types, pkey)
        return struct.pack(">i", RESULT_VOID)

    def _insert(self, s: str, keyspace) -> bytes:
        m = re.match(r"INSERT\s+INTO\s+([\w.]+)\s*\(([^)]*)\)\s*VALUES"
                     r"\s*\((.*)\)$", s, re.I | re.S)
        if not m:
            raise CassandraError("malformed INSERT")
        tbl = self._table(m.group(1), keyspace)
        cols = [c.strip().lower() for c in m.group(2).split(",")]
        vals = _split_csv(m.group(3))
        if len(cols) != len(vals):
            raise CassandraError("column/value count mismatch")
        asmap = {c: _parse_literal(v) for c, v in zip(cols, vals)}
        if tbl.pkey not in asmap:
            raise CassandraError(f"missing PRIMARY KEY {tbl.pkey}")
        row = [asmap.get(c) for c in tbl.columns]
        with self._lock:
            existing = tbl.rows.get(asmap[tbl.pkey])
            if existing is not None:     # Cassandra semantics: UPSERT
                row = [n if c in asmap else e
                       for c, n, e in zip(tbl.columns, row, existing)]
            tbl.rows[asmap[tbl.pkey]] = row
        return struct.pack(">i", RESULT_VOID)

    def _select(self, s: str, keyspace) -> bytes:
        m = re.match(r"SELECT\s+(.*?)\s+FROM\s+([\w.]+)"
                     r"(?:\s+WHERE\s+(\w+)\s*=\s*(.+?))?"
                     r"(?:\s+LIMIT\s+(\d+))?$", s, re.I | re.S)
        if not m:
            raise CassandraError("malformed SELECT")
        tbl = self._table(m.group(2), keyspace)
        proj = ([c.strip().lower() for c in m.group(1).split(",")]
                if m.group(1).strip() != "*" else list(tbl.columns))
        for c in proj:
            if c not in tbl.columns:
                raise CassandraError(f"unknown column {c}")
        with self._lock:
            rows = list(tbl.rows.values())
        if m.group(3):
            col = m.group(3).lower()
            want = _parse_literal(m.group(4).strip())
            at = tbl.columns.index(col)
            rows = [r for r in rows if r[at] == want]
        if m.group(5):
            rows = rows[:int(m.group(5))]
        ks, t = self._resolve(m.group(2), keyspace)
        idxs = [tbl.columns.index(c) for c in proj]
        tids = [tbl.type_ids()[i] for i in idxs]
        # ROWS result: flags(global table spec) col-count, ks/table,
        # per-col name+type, row count, values
        body = struct.pack(">i", RESULT_ROWS)
        body += struct.pack(">iI", 0x0001, len(proj))
        body += _string(ks) + _string(t)
        for c, tid in zip(proj, tids):
            body += _string(c) + struct.pack(">H", tid)
        body += struct.pack(">I", len(rows))
        for r in rows:
            for i, tid in zip(idxs, tids):
                body += _bytes_val(_enc_value(tid, r[i]))
        return body


def _split_csv(s: str) -> List[str]:
    """Split a VALUES list on commas outside single quotes."""
    out, cur, q = [], [], False
    for ch in s:
        if ch == "'":
            q = not q
            cur.append(ch)
        elif ch == "," and not q:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur).strip())
    return out


def _parse_literal(tok: str) -> Any:
    if tok.startswith("'") and tok.endswith("'"):
        return tok[1:-1].replace("''", "'")
    low = tok.lower()
    if low in ("true", "false"):
        return low == "true"
    if low == "null":
        return None
    try:
        return int(tok)
    except ValueError:
        return float(tok)


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class CqlClient:
    """Minimal CQL v4 driver: STARTUP handshake + QUERY cycle."""

    VERSION = 0x04

    def __init__(self, host: str, port: int, timeout_s: float = 10.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout_s)
        self._stream = 0
        try:
            opts = struct.pack(">H", 1) + _string("CQL_VERSION") \
                + _string("3.4.4")
            self.sock.sendall(_frame(self.VERSION, 0, OP_STARTUP, opts))
            fr = _read_frame(self.sock)
            if fr is None or fr[2] != OP_READY:
                raise CassandraError(f"startup failed: {fr and fr[2]}")
        except BaseException:
            self.sock.close()
            raise

    def execute(self, cql: str
                ) -> Tuple[List[Tuple[str, int]], List[List[Any]]]:
        """-> (columns as (name, type id), rows); non-SELECT returns
        ([], [])."""
        self._stream = (self._stream + 1) % 32000
        body = _long_string(cql) + struct.pack(">HB", 0x0001, 0)  # ONE
        self.sock.sendall(_frame(self.VERSION, self._stream, OP_QUERY,
                                 body))
        fr = _read_frame(self.sock)
        if fr is None:
            raise CassandraError("connection closed")
        _v, _stream, opcode, rbody = fr
        if opcode == OP_ERROR:
            (code,) = struct.unpack_from(">i", rbody, 0)
            msg, _ = _read_string(rbody, 4)
            raise CassandraError(f"[{code:#06x}] {msg}")
        if opcode != OP_RESULT:
            raise CassandraError(f"unexpected opcode {opcode}")
        (kind,) = struct.unpack_from(">i", rbody, 0)
        if kind != RESULT_ROWS:
            return [], []
        pos = 4
        flags, ncols = struct.unpack_from(">iI", rbody, pos)
        pos += 8
        if flags & 0x0001:
            _ks, pos = _read_string(rbody, pos)
            _t, pos = _read_string(rbody, pos)
        cols: List[Tuple[str, int]] = []
        for _ in range(ncols):
            name, pos = _read_string(rbody, pos)
            (tid,) = struct.unpack_from(">H", rbody, pos)
            pos += 2
            cols.append((name, tid))
        (nrows,) = struct.unpack_from(">I", rbody, pos)
        pos += 4
        rows = []
        for _ in range(nrows):
            row = []
            for _name, tid in cols:
                (ln,) = struct.unpack_from(">i", rbody, pos)
                pos += 4
                if ln < 0:
                    row.append(None)
                else:
                    row.append(_dec_value(tid, rbody[pos:pos + ln]))
                    pos += ln
            rows.append(row)
        return cols, rows

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# sink / source
# ---------------------------------------------------------------------------


def _cql_literal(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, (bool, np.bool_)):
        return "true" if v else "false"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return "'" + str(v).replace("'", "''") + "'"


class CassandraSink:
    """``CassandraSink`` analog: rows INSERT (= upsert by primary key)
    with flush-on-checkpoint — at-least-once, and effectively-once when
    the primary key is deterministic (replays overwrite themselves, the
    recipe the reference documents)."""

    clone_per_subtask = True

    def __init__(self, host: str, port: int, table: str,
                 columns: List[str], buffer_rows: int = 500):
        self.host, self.port = host, port
        self.table = table
        self.columns = list(columns)
        self.buffer_rows = buffer_rows
        self._client: Optional[CqlClient] = None
        self._buf: List[dict] = []

    def _cli(self) -> CqlClient:
        if self._client is None:
            self._client = CqlClient(self.host, self.port)
        return self._client

    def open(self, ctx) -> None:
        self._cli()

    def write_batch(self, batch) -> None:
        self._buf.extend(batch.to_rows())
        if len(self._buf) >= self.buffer_rows:
            self._flush()

    def _flush(self) -> None:
        if not self._buf:
            return
        c = self._cli()
        for r in self._buf:
            cols = ", ".join(self.columns)
            vals = ", ".join(_cql_literal(r.get(col))
                             for col in self.columns)
            c.execute(f"INSERT INTO {self.table} ({cols}) "
                      f"VALUES ({vals})")
        self._buf = []

    def snapshot_state(self) -> Dict[str, Any]:
        self._flush()               # flush-on-checkpoint
        return {}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self._buf = []

    def end_input(self) -> None:
        self._flush()

    def close(self) -> None:
        try:
            self._flush()
        except (CassandraError, OSError):
            pass
        if self._client is not None:
            self._client.close()
            self._client = None


class CassandraSource:
    """Bounded full-table scan (``CassandraInputFormat`` analog)."""

    bounded = True

    def __init__(self, host: str, port: int, table: str,
                 batch_rows: int = 4096,
                 timestamp_column: Optional[str] = None):
        self.host, self.port = host, port
        self.table = table
        self.batch_rows = batch_rows
        self.timestamp_column = timestamp_column

    def create_splits(self, parallelism: int):
        from flink_tpu_torch.connectors.sources import SourceSplit

        src = self

        class _Split(SourceSplit):
            def split_id(_self) -> str:
                return f"{src.table}-0"

            def read(_self):
                return src._scan()

        return [_Split(self, 0, 1)]

    def _scan(self):
        from flink_tpu_torch.connectors.util import rows_to_batch

        c = CqlClient(self.host, self.port)
        try:
            cols, rows = c.execute(f"SELECT * FROM {self.table}")
            names = [n for n, _t in cols]
            for lo in range(0, len(rows), self.batch_rows):
                chunk = [dict(zip(names, r))
                         for r in rows[lo:lo + self.batch_rows]]
                yield rows_to_batch(chunk, self.timestamp_column)
        finally:
            c.close()

"""Queryable state: the wire layer of the serving tier (port of
``flink_tpu/queryable/server.py``, host Python as JAX's).

Analog of ``flink-queryable-state`` (``KvStateServerImpl`` +
``KvStateServerHandler`` on each TM, ``KvStateRegistry`` in the runtime,
client proxy with location lookup), grown into a read path:
the registry fronts three entry kinds —

- **live views** (``view.WindowReadView``): barrier-free fire-time
  snapshots published by the operator, sharded per subtask and routed by
  the record's own key-group assignment;
- **checkpoint replicas** (``replica.CheckpointReplica``): lookups at the
  last-completed-checkpoint consistency level, never touching the hot path;
- **legacy backend states** (``register(name, backend, state)``): the
  original dirty point-read against a keyed backend's non-inserting index
  path, kept for compatibility.

Protocols (negotiated per request by one byte peek):

- **binary columnar** (``wire.py``): dtype-tagged ndarray
  columns off the immutable view/replica segments, zero per-key Python
  objects — the production-QPS path;
- **length-prefixed JSON** (the first protocol, kept as the fallback so old
  clients keep working): ``[state_name, key]`` (legacy point read)
  -> ``[status, value]``; ``{"state": s, "keys": [...], "consistency":
  "live"|"checkpoint"}`` (batched read) -> ``["ok", {"found": [...],
  "values": [...], "tags": {...}}]``; ``{"routing": true}`` -> ``["ok",
  <routing table>]`` (the key-group -> endpoint map clients fan out on).

JSON/binary, not pickle: requests arrive over the network from untrusted
clients, and unpickling attacker bytes is remote code execution.  Keys are
therefore limited to JSON scalars (str/int/float/bool) or raw int64.

Security: an unknown-state error reply names NOTHING — the registered
state list is logged server-side only (the old reply echoed the full list
to untrusted network clients).
"""

from __future__ import annotations

import json
import logging
import socket
import socketserver
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.cluster.net import recv_exact as _recv_exact
from flink_tpu_torch.queryable import wire
from flink_tpu_torch.queryable.view import plain as _plain

_LEN = struct.Struct("<I")
_LOG = logging.getLogger("flink_tpu_torch.queryable")

#: batched requests are bounded: a hostile 100M-key request must not make
#: the server materialize 100M answers
MAX_BATCH_KEYS = 1 << 16


class _LiveEntry:
    """Per-subtask live views of ONE registered state + the routing
    geometry (a query routes to the owning subtask exactly like a
    record: murmur key group -> contiguous key-group range)."""

    __slots__ = ("views", "parallelism", "max_parallelism")

    def __init__(self, views: List, parallelism: int, max_parallelism: int):
        self.views = list(views)
        self.parallelism = int(parallelism)
        self.max_parallelism = int(max_parallelism)

    @property
    def has_views(self) -> bool:
        """False for a pure routing placeholder (every view None — a
        coordinator advertising worker endpoints holds no views): live
        lookups against one must ERROR, not answer all-not-found."""
        return any(v is not None for v in self.views)

    @property
    def epoch(self) -> int:
        """Content version across every subtask's view (publish counter
        sum) — the hot-key cache's live invalidation signal."""
        return sum(v.epoch for v in self.views if v is not None)

    def lookup_batch(self, keys) -> Dict[str, Any]:
        from flink_tpu_torch.queryable.view import coerce_keys, route_keys
        keys = coerce_keys(keys)
        n = len(keys)
        found = np.zeros(n, bool)
        values: List[Optional[Dict[str, Any]]] = [None] * n
        owner = route_keys(keys, self.parallelism, self.max_parallelism)
        tags: List[Dict[str, Any]] = []
        for sub in np.unique(owner).tolist():
            if not (0 <= sub < len(self.views)):
                continue
            view = self.views[int(sub)]
            if view is None:       # per-worker registry: foreign subtask
                continue
            sel = np.flatnonzero(owner == sub)
            f, v, t = view.lookup_batch(np.asarray(keys)[sel])
            tags.append(t)
            for j, qi in enumerate(sel.tolist()):
                if f[j]:
                    found[qi] = True
                    values[qi] = v[j]
        return {"found": found.tolist(), "values": values,
                "tags": merge_live_tags(tags)}

    def lookup_batch_columnar(self, keys) -> Tuple[np.ndarray,
                                                   Dict[str, np.ndarray],
                                                   Dict[str, Any]]:
        """Binary-wire twin of :meth:`lookup_batch`: per-subtask columnar
        gathers merged into dense answer columns, zero per-key objects."""
        from flink_tpu_torch.queryable.view import coerce_keys, route_keys
        keys = coerce_keys(keys)
        n = len(keys)
        found = np.zeros(n, bool)
        cols: Dict[str, np.ndarray] = {}
        owner = route_keys(keys, self.parallelism, self.max_parallelism)
        tags: List[Dict[str, Any]] = []
        for sub in np.unique(owner).tolist():
            if not (0 <= sub < len(self.views)):
                continue
            view = self.views[int(sub)]
            if view is None:
                continue
            sel = np.flatnonzero(owner == sub)
            f, c, t = view.lookup_batch_columnar(np.asarray(keys)[sel])
            tags.append(t)
            hit = np.flatnonzero(f)
            if hit.size == 0:
                continue
            qsel = sel[hit]
            for name, arr in c.items():
                out = cols.get(name)
                if out is None:
                    out = cols[name] = (np.empty(n, object)
                                        if arr.dtype.kind == "O"
                                        else np.zeros(n, arr.dtype))
                got = arr[hit]
                out[qsel] = got if out.dtype == arr.dtype \
                    else got.astype(out.dtype)
            found[qsel] = True
        return found, cols, merge_live_tags(tags)


def merge_live_tags(tags: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One live answer's tags from several subtask views (or fanned-out
    sub-batches — the routed client merges with the same rule): the
    conservative reading, i.e. the OLDEST watermark/checkpoint any
    contributing view reflects."""
    wm = [t["watermark"] for t in tags if t.get("watermark") is not None]
    ck = [t["checkpoint_id"] for t in tags
          if t.get("checkpoint_id") is not None]
    return {"consistency": "live",
            "watermark": min(wm) if wm else None,
            "checkpoint_id": min(ck) if ck else None}


class KvStateRegistry:
    """Registered queryable states (``KvStateRegistry.java`` analog),
    extended with live views and checkpoint replicas."""

    def __init__(self):
        self._entries: Dict[str, Tuple[Any, Any]] = {}
        self._live: Dict[str, _LiveEntry] = {}
        self._replicas: Dict[str, Any] = {}
        #: client-side routing surface: per-state subtask -> (host, port)
        #: (per-worker serving), plus a default endpoint (this registry's
        #: own server) for states with no explicit map
        self._endpoints: Dict[str, Dict[int, Tuple[str, int]]] = {}
        self._default_endpoint: Optional[Tuple[str, int]] = None
        self._routing_epoch = 0
        self._lock = threading.Lock()

    # -- registration --------------------------------------------------------
    def register(self, state_name: str, backend, state) -> None:
        with self._lock:
            self._entries[state_name] = (backend, state)
            self._routing_epoch += 1

    def register_views(self, state_name: str, views: List,
                       parallelism: int, max_parallelism: int) -> None:
        """Expose per-subtask :class:`~flink_tpu_torch.queryable.view.
        WindowReadView` instances under one state name (re-registering
        replaces — region restarts rebuild operators).  ``views`` entries
        may be None for subtasks served elsewhere (a worker-local registry
        fronts only its own subtasks; the routing table sends clients to
        each subtask's owner)."""
        with self._lock:
            self._live[state_name] = _LiveEntry(views, parallelism,
                                                max_parallelism)
            self._routing_epoch += 1

    def register_replica(self, state_name: str, replica) -> None:
        with self._lock:
            self._replicas[state_name] = replica
            self._routing_epoch += 1

    def unregister(self, state_name: str) -> None:
        with self._lock:
            self._entries.pop(state_name, None)
            self._live.pop(state_name, None)
            self._replicas.pop(state_name, None)
            self._endpoints.pop(state_name, None)
            self._routing_epoch += 1

    # -- client-side routing surface -----------------------------------------
    def set_state_endpoints(self, state_name: str,
                            endpoints: Dict[int, Tuple[str, int]],
                            parallelism: Optional[int] = None,
                            max_parallelism: Optional[int] = None) -> None:
        """Advertise which server owns each subtask's state (the
        ``KvStateLocation`` analog).  ``parallelism``/``max_parallelism``
        register the routing geometry for states whose views live in
        OTHER processes (a coordinator advertising worker servers holds no
        views itself)."""
        with self._lock:
            cur = self._endpoints.setdefault(state_name, {})
            cur.update({int(i): (str(h), int(p))
                        for i, (h, p) in endpoints.items()})
            if parallelism is not None \
                    and state_name not in self._live:
                self._live[state_name] = _LiveEntry(
                    [None] * parallelism, parallelism,
                    max_parallelism or 128)
            self._routing_epoch += 1

    def set_default_endpoint(self, endpoint: Tuple[str, int]) -> None:
        """This registry's own server address — the fallback endpoint for
        every state without an explicit per-subtask map (the in-process
        MiniCluster: one server owns every subtask's view)."""
        with self._lock:
            self._default_endpoint = (str(endpoint[0]), int(endpoint[1]))
            self._routing_epoch += 1

    def routing_table(self) -> Dict[str, Any]:
        """The key-group -> endpoint map a client fans out on: per state,
        the routing geometry (parallelism / max_parallelism — the client
        runs the SAME murmur key-group assignment the operators route
        records with) and each subtask's owning server.  States with no
        per-subtask endpoints advertise every subtask at the default
        endpoint; replica-only states advertise kind="scan" (any endpoint
        answers the whole batch)."""
        with self._lock:
            states: Dict[str, Any] = {}
            names = set(self._live) | set(self._replicas) \
                | set(self._entries)
            for name in names:
                live = self._live.get(name)
                eps = dict(self._endpoints.get(name, {}))
                if live is None:
                    entry: Dict[str, Any] = {"kind": "scan"}
                    if self._default_endpoint is not None:
                        entry["endpoints"] = {0: list(
                            self._default_endpoint)}
                    states[name] = entry
                    continue
                if not eps and self._default_endpoint is not None:
                    eps = {i: self._default_endpoint
                           for i in range(live.parallelism)}
                states[name] = {
                    "kind": "subtask",
                    "parallelism": live.parallelism,
                    "max_parallelism": live.max_parallelism,
                    "endpoints": {int(i): list(ep)
                                  for i, ep in eps.items()},
                }
            return {"version": 1, "epoch": self._routing_epoch,
                    "states": states}

    def epoch_of(self, state_name: str, consistency: str):
        """Content version for the hot-key response cache: the replica's
        serving checkpoint id (checkpoint reads) or the live views'
        publish counter (live reads).  None = not cacheable."""
        with self._lock:
            if consistency == "checkpoint":
                rep = self._replicas.get(state_name)
                return None if rep is None else rep.epoch
            live = self._live.get(state_name)
            return None if live is None else live.epoch

    def names(self):
        with self._lock:
            return sorted(set(self._entries) | set(self._live)
                          | set(self._replicas))

    def replicas(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._replicas)

    def _unknown(self, state_name) -> Tuple[str, str]:
        # the registered-state list is logged SERVER-side only: echoing it
        # to an untrusted network client leaked the job's state topology
        _LOG.warning("queryable lookup for unknown state %r "
                     "(registered states: %s)", state_name, self.names())
        return "err", "unknown state"

    # -- point lookup (legacy protocol) --------------------------------------
    def lookup(self, state_name: str, key) -> Tuple[str, Any]:
        from flink_tpu_torch.queryable.view import is_scalar_key
        if not is_scalar_key(key):
            return "err", "key must be a JSON scalar (str/int/float/bool)"
        with self._lock:
            entry = self._entries.get(state_name)
            live = self._live.get(state_name)
            has_replica = state_name in self._replicas
        if entry is not None:
            return self._lookup_backend(entry, key)
        if live is not None and not live.has_views:
            return "err", "state's live views are served by per-worker " \
                          "endpoints — use a routing client (or the " \
                          "batched protocol with consistency=checkpoint)"
        if live is not None:
            got = live.lookup_batch([key])
            if got["found"][0]:
                return "ok", got["values"][0]
            return "missing", None
        if has_replica:
            # registered, but replica-only (e.g. a coordinator-side
            # serving tier): say so instead of "unknown state"
            return "err", "state served at checkpoint consistency only " \
                          "— use the batched protocol with " \
                          "consistency=checkpoint"
        return self._unknown(state_name)

    @staticmethod
    def _lookup_backend(entry, key) -> Tuple[str, Any]:
        backend, state = entry
        idx = getattr(backend, "_index", None)
        if idx is None:
            return "missing", None
        slots = idx.lookup(np.asarray([key]))    # NON-inserting
        slot = int(slots[0])
        if slot < 0:
            return "missing", None
        got = state.get_rows(np.asarray([slot]))
        if isinstance(got, tuple):               # (values, alive)
            vals, alive = got
            if not bool(np.asarray(alive)[0]):
                return "missing", None
            return "ok", _plain(np.asarray(vals)[0])
        return "ok", _plain(list(got)[0])

    # -- batched lookup ------------------------------------------------------
    def lookup_batch(self, state_name: str, keys,
                     consistency: str = "live") -> Tuple[str, Any]:
        from flink_tpu_torch.queryable.view import is_scalar_key
        if consistency not in ("live", "checkpoint"):
            return "err", f"unknown consistency {consistency!r} " \
                          f"(live|checkpoint)"
        if len(keys) > MAX_BATCH_KEYS:
            return "err", f"batch too large (max {MAX_BATCH_KEYS} keys)"
        if not all(is_scalar_key(k) for k in keys):
            # validate BEFORE hashing/routing: a list/dict/null key from
            # an untrusted client must be a clean error, not a handler-
            # thread exception that drops the connection mid-stream
            return "err", "keys must be JSON scalars (str/int/float/bool)"
        with self._lock:
            live = self._live.get(state_name)
            replica = self._replicas.get(state_name)
            legacy = self._entries.get(state_name)
        if live is None and replica is None and legacy is None:
            return self._unknown(state_name)
        if consistency == "checkpoint":
            if replica is None:
                return "err", "consistency 'checkpoint' not served for " \
                              "this state (no replica registered)"
            found, values, tags = replica.lookup_batch(keys)
            return "ok", {"found": found.tolist(), "values": values,
                          "tags": tags}
        if live is not None and not live.has_views:
            # routing placeholder (endpoints advertised, no local views):
            # an all-not-found answer would silently lie to old
            # non-routing clients — name the real situation instead
            return "err", "state's live views are served by per-worker " \
                          "endpoints — use a routing client (or query " \
                          "with consistency=checkpoint)"
        if live is not None:
            return "ok", live.lookup_batch(keys)
        if legacy is not None:
            found, values = [], []
            for k in keys:
                status, v = self._lookup_backend(legacy, k)
                found.append(status == "ok")
                values.append(v if status == "ok" else None)
            return "ok", {"found": found, "values": values,
                          "tags": {"consistency": "live"}}
        return "err", "state has no live read path (replica only — " \
                      "query with consistency=checkpoint)"

    # -- batched columnar lookup (binary wire) -------------------------------
    def lookup_batch_columnar(self, state_name: str, keys,
                              consistency: str = "live"
                              ) -> Tuple[str, Any]:
        """Binary-wire twin of :meth:`lookup_batch`: ``("ok", (found,
        cols, tags))`` with dense ndarray columns, or ``("err", msg)``
        with the SAME error texts as the JSON path (one contract, two
        encodings)."""
        from flink_tpu_torch.queryable.view import is_scalar_key
        if consistency not in ("live", "checkpoint"):
            return "err", f"unknown consistency {consistency!r} " \
                          f"(live|checkpoint)"
        if len(keys) > MAX_BATCH_KEYS:
            return "err", f"batch too large (max {MAX_BATCH_KEYS} keys)"
        if not (isinstance(keys, np.ndarray)
                and keys.dtype.kind in "iu") \
                and not all(is_scalar_key(k) for k in keys):
            return "err", "keys must be JSON scalars (str/int/float/bool)"
        with self._lock:
            live = self._live.get(state_name)
            replica = self._replicas.get(state_name)
            legacy = self._entries.get(state_name)
        if live is None and replica is None and legacy is None:
            return self._unknown(state_name)
        if consistency == "checkpoint":
            if replica is None:
                return "err", "consistency 'checkpoint' not served for " \
                              "this state (no replica registered)"
            return "ok", replica.lookup_batch_columnar(keys)
        if live is not None and not live.has_views:
            return "err", "state's live views are served by per-worker " \
                          "endpoints — use a routing client (or query " \
                          "with consistency=checkpoint)"
        if live is not None:
            return "ok", live.lookup_batch_columnar(keys)
        if legacy is not None:
            # legacy backend states have no columnar read path: answer
            # binary clients through the dict path (slow, compatible)
            status, got = self.lookup_batch(state_name, list(keys),
                                            consistency)
            if status != "ok":
                return status, got
            found = np.asarray(got["found"], bool)
            cols = wire.columnar_from_values(found, got["values"])
            return "ok", (found, cols, got.get("tags", {}))
        return "err", "state has no live read path (replica only — " \
                      "query with consistency=checkpoint)"


def _json_safe(v):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return str(v)


def _answer_binary(registry, payload: bytes) -> bytes:
    """One binary request -> one binary response (never an exception: the
    same never-kill-the-connection contract as the JSON path)."""
    try:
        state, keys, consistency = wire.decode_request(payload)
    except (wire.WireError, ValueError, TypeError, KeyError, IndexError,
            struct.error, UnicodeDecodeError) as e:
        # truncated/corrupt frames surface as struct.error / bad-UTF-8 /
        # json errors, not just WireError — all must answer, never kill
        # the connection (the pooled client would burn retries on a
        # poison frame)
        return wire.encode_error(f"malformed request: {e}")
    try:
        status, out = registry.lookup_batch_columnar(state, keys,
                                                     consistency)
        if status != "ok":
            return wire.encode_error(out)
        found, cols, tags = out
        return wire.encode_response(found, cols, tags)
    except Exception:  # noqa: BLE001
        _LOG.exception("queryable binary lookup failed")
        return wire.encode_error("internal error")


class QueryableStateServer:
    """TCP server answering point + batched queries (``KvStateServerImpl``
    analog).  ``registry`` may be a :class:`KvStateRegistry` or anything
    exposing the same ``lookup``/``lookup_batch`` (the serving tier passes
    its instrumented :class:`~flink_tpu_torch.queryable.service.
    QueryableStateService`)."""

    def __init__(self, registry, host: str = "127.0.0.1", port: int = 0):
        self.registry = registry
        registry_ref = registry

        #: live handler connections — stop() severs them so a stopped
        #: server goes DARK immediately (daemon handler threads would
        #: otherwise keep answering on established sockets, hiding a
        #: worker restart from routed clients)
        active: set = set()
        active_lock = threading.Lock()

        class Handler(socketserver.BaseRequestHandler):
            def setup(self):
                with active_lock:
                    active.add(self.request)

            def finish(self):
                with active_lock:
                    active.discard(self.request)

            def handle(self):
                try:
                    while True:
                        hdr = _recv_exact(self.request, _LEN.size)
                        if hdr is None:
                            return
                        (n,) = _LEN.unpack(hdr)
                        payload = _recv_exact(self.request, n)
                        if payload is None:
                            return
                        # server-side SERVICE time: the whole answer —
                        # lookup AND serialization — measured where the
                        # GIL can't hide it behind a slow client (the
                        # client-side p99 is a different number on a
                        # loaded box; the panel shows both)
                        t0 = time.perf_counter()
                        if wire.is_binary(payload):
                            data = _answer_binary(registry_ref, payload)
                            proto = "binary"
                        else:
                            resp = self._answer(payload)
                            data = json.dumps(
                                resp, default=_json_safe).encode()
                            proto = "json"
                        rec = getattr(registry_ref, "record_serve", None)
                        if rec is not None:
                            rec((time.perf_counter() - t0) * 1e3, proto)
                        self.request.sendall(_LEN.pack(len(data)) + data)
                except (ConnectionError, OSError):
                    return

            @staticmethod
            def _answer(payload: bytes):
                try:
                    req = json.loads(payload)
                except (ValueError, TypeError):
                    return ("err", "malformed request")
                try:
                    if isinstance(req, dict):
                        if req.get("routing"):
                            return ("ok", registry_ref.routing_table())
                        state = req.get("state")
                        keys = req.get("keys")
                        if not isinstance(state, str) \
                                or not isinstance(keys, list):
                            return ("err", "malformed request")
                        return registry_ref.lookup_batch(
                            state, keys, req.get("consistency", "live"))
                    state_name, key = req
                    return registry_ref.lookup(state_name, key)
                except (ValueError, TypeError):
                    return ("err", "malformed request")
                except Exception:  # noqa: BLE001 — an untrusted request
                    # must never kill the connection without a reply (the
                    # pooled client would burn retries on a poison pill)
                    _LOG.exception("queryable lookup failed")
                    return ("err", "internal error")

        self._server = socketserver.ThreadingTCPServer((host, port), Handler,
                                                       bind_and_activate=True)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address
        # the registry's default routing endpoint IS this server (states
        # with a per-subtask map — per-worker serving — override it)
        sde = getattr(registry, "set_default_endpoint", None)
        if sde is not None:
            sde((self.host, self.port))
        self._active = active
        self._active_lock = active_lock
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="kv-state-server", daemon=True)

    def start(self) -> "QueryableStateServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        # sever established connections too: a stopped server must go
        # dark, not linger answering on old sockets
        with self._active_lock:
            conns = list(self._active)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass


class QueryableStateClient:
    """``QueryableStateClient`` analog: connect + get.  Single socket, no
    retry — the original client, kept working; use
    :class:`QueryableStateClientPool` for pooling/retry/backoff."""

    def __init__(self, host: str, port: int, timeout_s: float = 5.0):
        self._sock = socket.create_connection((host, port), timeout=timeout_s)

    def get(self, state_name: str, key) -> Any:
        """Point lookup; raises KeyError if the key has no state."""
        payload = json.dumps([state_name, key]).encode()
        self._sock.sendall(_LEN.pack(len(payload)) + payload)
        hdr = _recv_exact(self._sock, _LEN.size)
        if hdr is None:
            raise ConnectionError("server closed")
        (n,) = _LEN.unpack(hdr)
        data = _recv_exact(self._sock, n)
        if data is None:
            raise ConnectionError("server closed mid-response")
        status, value = json.loads(data)
        if status == "ok":
            return value
        if status == "missing":
            raise KeyError(key)
        raise RuntimeError(value)

    def close(self) -> None:
        self._sock.close()


class QueryableStateClientPool:
    """Connection-pooled client with retry/timeout/backoff, per-endpoint
    pools, protocol negotiation and client-side key-group routing (the
    serving tier's front-door client).

    **Protocols** — ``protocol=``:

    - ``"json"`` (default): the length-prefixed-JSON protocol, wire-
      compatible with old servers;
    - ``"binary"``: the columnar wire (``wire.py``) — fails loudly against
      a server that only speaks JSON;
    - ``"auto"``: binary first, silently downgrading an endpoint to JSON
      when its server answers a binary frame with a JSON error (old
      server) — the negotiation that lets fleets upgrade one side at a
      time.

    **Routing** — ``routing=True`` fetches the server's routing table
    (``{"routing": true}``) and hash-partitions every batch with the SAME
    murmur key-group assignment the operators route records with
    (``view.route_keys`` == ``ShardLayout.route_keys``), fanning each
    sub-batch straight to the worker that owns the keys' key groups and
    skipping the coordinator hop entirely.

    **Failure handling**: lookups are idempotent reads, so a request that
    dies mid-stream EVICTS the broken socket first, then marks the routing
    table stale, THEN retries — eviction strictly precedes the retry's
    routing-table refresh, so a refreshed map can never hand the retry a
    dead pooled connection (a worker restarted on a new port is one
    refresh away)."""

    def __init__(self, host: str, port: int, size: int = 4,
                 timeout_s: float = 5.0, retries: int = 1,
                 backoff_s: float = 0.05, protocol: str = "json",
                 routing: bool = False):
        if protocol not in ("json", "binary", "auto"):
            raise ValueError(f"unknown protocol {protocol!r} "
                             f"(json|binary|auto)")
        self.host = host
        self.port = port
        self.bootstrap = (host, int(port))
        self.size = max(1, int(size))
        self.timeout_s = timeout_s
        self.retries = max(0, int(retries))
        self.backoff_s = backoff_s
        self.protocol = protocol
        self.routing = bool(routing)
        self._idle: Dict[Tuple[str, int], List[socket.socket]] = {}
        self._json_only: set = set()        # endpoints negotiated down
        self._routing_table: Optional[Dict[str, Any]] = None
        self._no_routing = False            # server predates routing
        self._lock = threading.Lock()
        self._closed = False
        self.stats = {"requests": 0, "retries": 0, "evictions": 0,
                      "routing_refreshes": 0, "routed_batches": 0,
                      "fanout_requests": 0, "json_fallbacks": 0}

    # -- pool plumbing -------------------------------------------------------
    def _checkout(self, ep: Tuple[str, int]) -> socket.socket:
        with self._lock:
            if self._closed:
                raise RuntimeError("client pool is closed")
            pool = self._idle.get(ep)
            if pool:
                return pool.pop()
        return socket.create_connection(ep, timeout=self.timeout_s)

    def _checkin(self, ep: Tuple[str, int], sock: socket.socket) -> None:
        with self._lock:
            if not self._closed:
                pool = self._idle.setdefault(ep, [])
                if len(pool) < self.size:
                    pool.append(sock)
                    return
        sock.close()

    def _evict(self, sock: socket.socket) -> None:
        self.stats["evictions"] += 1
        try:
            sock.close()
        except OSError:
            pass

    def _rpc(self, ep: Tuple[str, int], payload: bytes) -> bytes:
        """One framed round trip on a pooled connection.  A broken stream
        evicts the socket BEFORE the error propagates — the evict-then-
        retry ordering the routed retry path depends on."""
        sock = None
        try:
            sock = self._checkout(ep)
            sock.sendall(_LEN.pack(len(payload)) + payload)
            hdr = _recv_exact(sock, _LEN.size)
            if hdr is None:
                raise ConnectionError("server closed")
            (n,) = _LEN.unpack(hdr)
            data = _recv_exact(sock, n)
            if data is None:
                raise ConnectionError("server closed mid-response")
        except (ConnectionError, OSError):
            # broken mid-stream: the socket may hold half a response —
            # NEVER back in the pool
            if sock is not None:
                self._evict(sock)
            raise
        self._checkin(ep, sock)
        self.stats["requests"] += 1
        return data

    def _request(self, obj) -> Any:
        """Bootstrap-endpoint JSON round trip with eviction + bounded
        retry (the legacy point-lookup path)."""
        payload = json.dumps(obj).encode()
        last_err: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            if attempt:
                self.stats["retries"] += 1
                time.sleep(self.backoff_s * (2 ** (attempt - 1)))
            try:
                data = self._rpc(self.bootstrap, payload)
            except (ConnectionError, OSError) as e:
                last_err = e
                continue
            return json.loads(data)
        raise ConnectionError(
            f"queryable lookup failed after {self.retries + 1} attempts: "
            f"{last_err}") from last_err

    # -- routing -------------------------------------------------------------
    def refresh_routing(self) -> Dict[str, Any]:
        """Re-fetch the key-group -> endpoint map from the bootstrap
        server.  Raises RuntimeError when the server predates routing."""
        data = self._rpc(self.bootstrap,
                         json.dumps({"routing": True}).encode())
        status, table = json.loads(data)
        if status != "ok":
            raise RuntimeError(table)
        with self._lock:
            self._routing_table = table
        self.stats["routing_refreshes"] += 1
        return table

    def invalidate_routing(self) -> None:
        with self._lock:
            self._routing_table = None

    def _routing_for(self, state: str) -> Optional[Dict[str, Any]]:
        if self._no_routing:
            return None
        table = self._routing_table
        if table is None:
            try:
                table = self.refresh_routing()
            except (ConnectionError, OSError):
                raise
            except RuntimeError:
                self._no_routing = True     # old server: stop asking
                return None
        return (table.get("states") or {}).get(state)

    def _split_by_endpoint(self, state: str, keys):
        """{endpoint: query-index array} under the advertised routing
        geometry, or None when the batch should go to the bootstrap
        endpoint whole (no map / scan-kind state / incomplete map)."""
        ent = self._routing_for(state)
        if not ent or ent.get("kind") != "subtask":
            return None
        eps = ent.get("endpoints") or {}
        if not eps:
            return None
        from flink_tpu_torch.queryable.view import route_keys
        arr = keys if isinstance(keys, np.ndarray) \
            else np.asarray(list(keys), object)
        owner = route_keys(arr, int(ent["parallelism"]),
                           int(ent["max_parallelism"]))
        groups: Dict[Tuple[str, int], List[np.ndarray]] = {}
        for sub in np.unique(owner).tolist():
            ep = eps.get(str(sub), eps.get(sub))
            if ep is None:
                return None    # incomplete map: serve via bootstrap
            key_ep = (str(ep[0]), int(ep[1]))
            groups.setdefault(key_ep, []).append(
                np.flatnonzero(owner == sub))
        return {ep: np.concatenate(sels) for ep, sels in groups.items()}

    # -- one endpoint, one sub-batch ----------------------------------------
    def _fetch_columnar(self, ep: Tuple[str, int], state: str, keys,
                        consistency: str):
        """-> (found, cols, tags) from one endpoint, negotiating the
        protocol per endpoint."""
        if self.protocol != "json" and ep not in self._json_only:
            data = self._rpc(ep, wire.encode_request(state, keys,
                                                     consistency))
            if wire.is_binary(data):
                return wire.decode_response(data)    # RuntimeError on err
            if self.protocol == "binary":
                raise RuntimeError(
                    "server does not speak the binary wire protocol "
                    "(use protocol='auto' to negotiate down to JSON)")
            self._json_only.add(ep)
            self.stats["json_fallbacks"] += 1
        key_list = keys.tolist() if isinstance(keys, np.ndarray) \
            else list(keys)
        data = self._rpc(ep, json.dumps(
            {"state": state, "keys": key_list,
             "consistency": consistency}).encode())
        status, value = json.loads(data)
        if status != "ok":
            raise RuntimeError(value)
        found = np.asarray(value["found"], bool)
        cols = wire.columnar_from_values(found, value["values"])
        return found, cols, value.get("tags", {})

    def _dispatch_columnar(self, state: str, keys, consistency: str):
        groups = self._split_by_endpoint(state, keys) \
            if self.routing else None
        if groups is None:
            return self._fetch_columnar(self.bootstrap, state, keys,
                                        consistency)
        self.stats["routed_batches"] += 1
        n = len(keys)
        found = np.zeros(n, bool)
        cols: Dict[str, np.ndarray] = {}
        tag_list: List[Dict[str, Any]] = []
        for ep, sel in groups.items():
            sub = keys[sel] if isinstance(keys, np.ndarray) \
                else [keys[i] for i in sel.tolist()]
            f, c, t = self._fetch_columnar(ep, state, sub, consistency)
            self.stats["fanout_requests"] += 1
            tag_list.append(t)
            found[sel] = f
            hit = np.flatnonzero(f)
            if hit.size == 0:
                continue
            qsel = sel[hit]
            for name, arr in c.items():
                out = cols.get(name)
                if out is None:
                    out = cols[name] = (np.empty(n, object)
                                        if arr.dtype.kind == "O"
                                        else np.zeros(n, arr.dtype))
                got = arr[hit]
                out[qsel] = got if out.dtype == arr.dtype \
                    else got.astype(out.dtype)
        return found, cols, _merge_client_tags(tag_list, consistency)

    # -- API -----------------------------------------------------------------
    def get(self, state_name: str, key) -> Any:
        status, value = self._request([state_name, key])
        if status == "ok":
            return value
        if status == "missing":
            raise KeyError(key)
        raise RuntimeError(value)

    def get_batch_columnar(self, state_name: str, keys,
                           consistency: str = "live"
                           ) -> Tuple[np.ndarray, Dict[str, np.ndarray],
                                      Dict[str, Any]]:
        """The production read API: one batch in, ``(found bool[n],
        {col: ndarray[n]}, tags)`` out — zero per-key Python objects end
        to end on the binary protocol, routed per key group when routing
        is on.  Retries evict first, refresh the routing map second, and
        only then re-dispatch (a stale endpoint map self-heals)."""
        if isinstance(keys, np.ndarray):
            karr = keys
        else:
            keys = list(keys)
            karr = np.asarray(keys, np.int64) \
                if keys and all(isinstance(k, (int, np.integer))
                                and not isinstance(k, bool)
                                for k in keys) else keys
        last_err: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            if attempt:
                self.stats["retries"] += 1
                time.sleep(self.backoff_s * (2 ** (attempt - 1)))
                if self.routing:
                    # the broken socket was already evicted by _rpc —
                    # refresh the map NOW so the retry dials the current
                    # owner, not the endpoint that just died
                    try:
                        self.refresh_routing()
                    except (ConnectionError, OSError, RuntimeError):
                        self.invalidate_routing()
            try:
                return self._dispatch_columnar(state_name, karr,
                                               consistency)
            except (ConnectionError, OSError) as e:
                last_err = e
                continue
        raise ConnectionError(
            f"queryable lookup failed after {self.retries + 1} attempts: "
            f"{last_err}") from last_err

    def get_batch(self, state_name: str, keys,
                  consistency: str = "live") -> Dict[str, Any]:
        """One request, N keys: ``{"found": [...], "values": [...],
        "tags": {...}}`` (the JSON answer shape, whatever protocol/routing
        serves it underneath)."""
        if self.protocol == "json" and not self.routing:
            # the JSON wire path, byte-for-byte (old servers included)
            status, value = self._request({"state": state_name,
                                           "keys": list(keys),
                                           "consistency": consistency})
            if status == "ok":
                return value
            raise RuntimeError(value)
        found, cols, tags = self.get_batch_columnar(state_name, keys,
                                                    consistency)
        return {"found": found.tolist(),
                "values": wire.values_from_columnar(found, cols),
                "tags": tags}

    def close(self) -> None:
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, {}
        for pool in idle.values():
            for s in pool:
                try:
                    s.close()
                except OSError:
                    pass


def _merge_client_tags(tags: List[Dict[str, Any]],
                       consistency: str) -> Dict[str, Any]:
    """Fanned-out sub-batch tags -> one answer's tags: the conservative
    merge (oldest watermark/checkpoint, worst replica lag)."""
    if len(tags) == 1:
        return tags[0]
    out: Dict[str, Any] = {"consistency": consistency}
    for k in ("watermark", "checkpoint_id"):
        vals = [t[k] for t in tags if t.get(k) is not None]
        if vals or any(k in t for t in tags):
            out[k] = min(vals) if vals else None
    for k in ("replica_lag_checkpoints", "replica_lag_ms"):
        vals = [t[k] for t in tags if t.get(k) is not None]
        if vals or any(k in t for t in tags):
            out[k] = max(vals) if vals else 0
    return out



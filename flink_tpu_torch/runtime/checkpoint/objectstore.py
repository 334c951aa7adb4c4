"""Object-store checkpoint storage: snapshots behind an S3-shaped service.

The reference persists checkpoints to pluggable remote filesystems
(``flink-filesystems/flink-s3-fs-base``, ``FsCheckpointStorageAccess``);
this module provides the same seam against an HTTP object store — a
standalone :class:`ObjectStoreServer` (``ObjectStoreServer(dir).start()``,
on loopback by default) speaking a minimal S3-like protocol, and
:class:`ObjectStoreCheckpointStorage` implementing the exact storage
interface of ``FileCheckpointStorage`` (store/load/load_latest/
checkpoint_ids/metadata) over it.

Wire protocol:
  - ``PUT    /o/{key}``          store object (atomic: temp + rename)
  - ``GET    /o/{key}``          fetch object
  - ``GET    /list?prefix=P``    JSON list of keys
  - ``DELETE /o/{key}``          remove object

The server also exposes **TTL leases with fencing tokens** (the etcd-lease /
ZooKeeper-ephemeral-node analog, ``ZooKeeperLeaderElectionDriver``):
  - ``POST /lease/{name}/acquire``  body {holder, ttl_ms} ->
        {acquired, holder, token, expires_in_ms}; a lease is granted when
        free or expired; every new grant bumps the monotone fencing token
  - ``POST /lease/{name}/renew``    body {holder, token, ttl_ms}
  - ``POST /lease/{name}/release``  body {holder, token}
  - ``GET  /lease/{name}``          current state
Cross-host leader election (``cluster/ha.py`` LeaseLeaderElection) rides
these endpoints, with fencing tokens guarding split-brain writers.

The port's copy of ``flink_tpu/runtime/checkpoint/objectstore.py`` (host Python, as JAX's).
"""

from __future__ import annotations

import json
import os
import pickle
import threading
import time
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from flink_tpu_torch.runtime.checkpoint.storage import (FORMAT_VERSION,
                                                       _to_numpy, loads)
from flink_tpu_torch.testing import chaos


class ObjectStoreServer:
    """Minimal durable object store over HTTP (keys -> files on disk)."""

    def __init__(self, directory: str, host: str = "127.0.0.1",
                 port: int = 0):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        #: lease table: name -> {holder, token, expires (monotonic)}
        self._leases: Dict[str, Dict[str, Any]] = {}
        self._lease_lock = threading.Lock()
        self._token_path = os.path.join(directory, "_lease_tokens.json")
        try:
            with open(self._token_path) as f:
                payload = json.load(f)
            self._next_token = int(payload["next"])
            #: per-election LAST granted token (persisted): fencing after a
            #: restart must compare against the election's own newest
            #: grant, not the shared counter
            self._last_grant: Dict[str, int] = {
                k: int(v) for k, v in payload.get("last", {}).items()}
        except (OSError, ValueError, KeyError):
            self._next_token = 1
            self._last_grant = {}
        store = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _path(self, key: str) -> str:
                safe = urllib.parse.quote(key, safe="")
                return os.path.join(store.directory, safe)

            def _json(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                parts = [p for p in self.path.split("/") if p]
                if len(parts) == 3 and parts[0] == "lease":
                    ln = int(self.headers.get("Content-Length", 0))
                    try:
                        req = json.loads(self.rfile.read(ln) or b"{}")
                    except ValueError:
                        return self._json(400, {"error": "bad json"})
                    name, verb = parts[1], parts[2]
                    if verb == "acquire":
                        return self._json(200, store.lease_acquire(
                            name, str(req.get("holder", "")),
                            int(req.get("ttl_ms", 10_000))))
                    if verb == "renew":
                        return self._json(200, store.lease_renew(
                            name, str(req.get("holder", "")),
                            int(req.get("token", -1)),
                            int(req.get("ttl_ms", 10_000))))
                    if verb == "release":
                        return self._json(200, store.lease_release(
                            name, str(req.get("holder", "")),
                            int(req.get("token", -1))))
                self._json(404, {"error": "not found"})

            def do_PUT(self):
                if not self.path.startswith("/o/"):
                    self.send_error(404)
                    return
                key = urllib.parse.unquote(self.path[3:])
                ln = int(self.headers["Content-Length"])
                data = self.rfile.read(ln)
                # fenced writes: a writer presenting a fencing token older
                # than the election's latest grant is a DEPOSED leader —
                # reject (the split-brain guard the lease tokens exist for)
                election = self.headers.get("X-Fencing-Election")
                if election is not None:
                    try:
                        tok = int(self.headers.get("X-Fencing-Token", -1))
                    except ValueError:
                        tok = -1
                    if not store.fencing_valid(election, tok):
                        return self._json(
                            412, {"error": "fencing token superseded",
                                  "election": election})
                path = self._path(key)
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_GET(self):
                parts = [p for p in self.path.split("?")[0].split("/") if p]
                if len(parts) == 2 and parts[0] == "lease":
                    return self._json(200, store.lease_state(parts[1]))
                if self.path.startswith("/o/"):
                    key = urllib.parse.unquote(self.path[3:])
                    path = self._path(key)
                    if not os.path.exists(path):
                        self.send_error(404)
                        return
                    with open(path, "rb") as f:
                        data = f.read()
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                if self.path.startswith("/list"):
                    q = urllib.parse.parse_qs(
                        urllib.parse.urlsplit(self.path).query)
                    prefix = q.get("prefix", [""])[0]
                    keys = sorted(
                        urllib.parse.unquote(n)
                        for n in os.listdir(store.directory)
                        if not n.endswith(".tmp")
                        and urllib.parse.unquote(n).startswith(prefix))
                    body = json.dumps(keys).encode()
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self.send_error(404)

            def do_DELETE(self):
                if not self.path.startswith("/o/"):
                    self.send_error(404)
                    return
                key = urllib.parse.unquote(self.path[3:])
                try:
                    os.remove(self._path(key))
                except FileNotFoundError:
                    pass
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self.url = f"http://{self.host}:{self.port}"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="object-store", daemon=True)

    # -- lease primitives (single authority, like an etcd leader) ---------
    def lease_acquire(self, name: str, holder: str,
                      ttl_ms: int) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lease_lock:
            cur = self._leases.get(name)
            if cur is not None and cur["expires"] > now \
                    and cur["holder"] != holder:
                return {"acquired": False, "holder": cur["holder"],
                        "expires_in_ms": int((cur["expires"] - now) * 1000)}
            if cur is not None and cur["holder"] == holder \
                    and cur["expires"] > now:
                cur["expires"] = now + ttl_ms / 1000.0
                return {"acquired": True, "holder": holder,
                        "token": cur["token"], "expires_in_ms": ttl_ms}
            token = self._next_token
            self._next_token += 1
            self._last_grant[name] = token
            tmp = self._token_path + ".tmp"
            with open(tmp, "w") as f:  # tokens survive server restarts
                json.dump({"next": self._next_token,
                           "last": self._last_grant}, f)
            os.replace(tmp, self._token_path)
            self._leases[name] = {"holder": holder, "token": token,
                                  "expires": now + ttl_ms / 1000.0}
            return {"acquired": True, "holder": holder, "token": token,
                    "expires_in_ms": ttl_ms}

    def lease_renew(self, name: str, holder: str, token: int,
                    ttl_ms: int) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lease_lock:
            cur = self._leases.get(name)
            if cur is None or cur["holder"] != holder \
                    or cur["token"] != token or cur["expires"] <= now:
                return {"renewed": False}
            cur["expires"] = now + ttl_ms / 1000.0
            return {"renewed": True, "token": token}

    def lease_release(self, name: str, holder: str,
                      token: int) -> Dict[str, Any]:
        with self._lease_lock:
            cur = self._leases.get(name)
            if cur is not None and cur["holder"] == holder \
                    and cur["token"] == token:
                del self._leases[name]
                return {"released": True}
            return {"released": False}

    def fencing_valid(self, election: str, token: int) -> bool:
        """A presented token is valid unless a NEWER grant exists for the
        election (the write may proceed even if the lease lapsed, as long
        as nobody else was granted since — standard fencing semantics)."""
        with self._lease_lock:
            cur = self._leases.get(election)
            if cur is not None:
                return token >= cur["token"]
            # no live record (e.g. after a server restart): only THIS
            # election's latest historical grant can still be valid —
            # older ones are deposed by construction; elections that were
            # never granted reject everything (fail closed)
            last = self._last_grant.get(election)
            return last is not None and token == last

    def lease_state(self, name: str) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lease_lock:
            cur = self._leases.get(name)
            if cur is None or cur["expires"] <= now:
                return {"held": False}
            return {"held": True, "holder": cur["holder"],
                    "token": cur["token"],
                    "expires_in_ms": int((cur["expires"] - now) * 1000)}

    def start(self) -> "ObjectStoreServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def serve_forever(self) -> None:
        self._httpd.serve_forever()


class ObjectStoreClient:
    def __init__(self, url: str, timeout_s: float = 60.0):
        self.url = url.rstrip("/")
        self.timeout_s = timeout_s

    def _req(self, method: str, path: str, body: Optional[bytes] = None,
             headers: Optional[Dict[str, str]] = None):
        req = urllib.request.Request(self.url + path, data=body,
                                     method=method, headers=headers or {})
        return urllib.request.urlopen(req, timeout=self.timeout_s)

    def put(self, key: str, data: bytes,
            fencing: Optional[tuple] = None) -> None:
        """``fencing=(election, token)``: the server rejects the write with
        412 when a newer fencing token was granted for that election — a
        deposed leader cannot corrupt shared state."""
        headers = {}
        if fencing is not None:
            headers = {"X-Fencing-Election": str(fencing[0]),
                       "X-Fencing-Token": str(fencing[1])}
        self._req("PUT", "/o/" + urllib.parse.quote(key, safe=""),
                  data, headers).read()

    def get(self, key: str) -> bytes:
        with self._req("GET", "/o/" + urllib.parse.quote(key, safe="")) as r:
            return r.read()

    def list(self, prefix: str = "") -> List[str]:
        with self._req("GET", "/list?prefix="
                       + urllib.parse.quote(prefix)) as r:
            return json.loads(r.read())

    def delete(self, key: str) -> None:
        self._req("DELETE", "/o/"
                  + urllib.parse.quote(key, safe="")).read()


class ObjectStoreCheckpointStorage:
    """Checkpoint storage against the object store — same interface (and
    key layout) as ``FileCheckpointStorage``: ``{prefix}chk-{id}/op-{j}.pkl``
    objects plus a ``_metadata.json`` published LAST (readers only trust
    checkpoints whose metadata object exists — the atomic-rename analog)."""

    def __init__(self, url: str, prefix: str = "", retain: int = 3,
                 client=None):
        """``client``: any object with put/get/list/delete — the same
        layout+metadata protocol then runs over other stores (e.g. the S3
        dialect, ``filesystems/s3.py``)."""
        self.client = client if client is not None else ObjectStoreClient(url)
        self.prefix = prefix
        self.retain = retain

    def _meta_key(self, cid: int) -> str:
        return f"{self.prefix}chk-{cid}/_metadata.json"

    def store(self, checkpoint_id: int, snapshot: Dict[str, Any]) -> None:
        chaos.fire("checkpoint.store", checkpoint_id=checkpoint_id)
        uids = []
        for uid, op_snap in snapshot.items():
            fname = f"op-{len(uids)}.pkl"
            uids.append({"uid": uid, "file": fname})
            self.client.put(f"{self.prefix}chk-{checkpoint_id}/{fname}",
                            pickle.dumps(_to_numpy(op_snap), protocol=4))
        meta = {"version": FORMAT_VERSION, "checkpoint_id": checkpoint_id,
                "timestamp_ms": int(time.time() * 1000), "operators": uids}
        # metadata LAST: its presence publishes the checkpoint
        self.client.put(self._meta_key(checkpoint_id),
                        json.dumps(meta).encode())
        self._cleanup()

    def _cleanup(self) -> None:
        ids = self.checkpoint_ids()
        for cid in ids[: max(0, len(ids) - self.retain)]:
            for key in self.client.list(f"{self.prefix}chk-{cid}/"):
                self.client.delete(key)

    def checkpoint_ids(self) -> List[int]:
        out = []
        for key in self.client.list(self.prefix):
            tail = key[len(self.prefix):]
            if tail.endswith("/_metadata.json") and tail.startswith("chk-"):
                cid = tail[4:].split("/", 1)[0]
                if cid.isdigit():
                    out.append(int(cid))
        return sorted(out)

    def load(self, checkpoint_id: int) -> Dict[str, Any]:
        chaos.fire("checkpoint.load", checkpoint_id=checkpoint_id)
        meta = json.loads(self.client.get(self._meta_key(checkpoint_id)))
        if meta["version"] > FORMAT_VERSION:
            raise ValueError(f"checkpoint format {meta['version']} too new")
        out: Dict[str, Any] = {}
        for entry in meta["operators"]:
            out[entry["uid"]] = loads(self.client.get(
                f"{self.prefix}chk-{checkpoint_id}/{entry['file']}"))
        return out

    def load_latest(self) -> Optional[Dict[str, Any]]:
        ids = self.checkpoint_ids()
        return self.load(ids[-1]) if ids else None

    def metadata(self, checkpoint_id: int) -> Dict[str, Any]:
        return json.loads(self.client.get(self._meta_key(checkpoint_id)))

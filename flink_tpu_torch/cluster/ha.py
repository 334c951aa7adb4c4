"""High availability: leader election + durable job metadata (port of
``flink_tpu/cluster/ha.py``, host Python as JAX's).

Analog of the reference's HA services (``runtime/highavailability/``:
ZooKeeper/K8s leader election via ``ZooKeeperLeaderElectionDriver`` +
``DefaultLeaderElectionService``, job-graph and checkpoint-pointer
persistence).  No quorum service exists in this environment, so leadership
is a **file lease**: the leader holds a lock file with a heartbeat
timestamp; contenders campaign by atomically creating it (O_EXCL) or taking
over once the lease expires.  Same contract as the reference: at most one
leader per election path, leadership revocable, listeners notified.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional


class FileLeaderElection:
    """flock-based leader election (one election per ``path``).

    Leadership = holding an exclusive ``flock`` on the lock file: the kernel
    guarantees a single holder, and releases the lock automatically when the
    holder's fd closes (crash included) — strictly stronger than a timestamp
    lease, which has a dual-leader window between expiry checks.  The
    ``lease_ms`` parameter is kept for API compatibility (it bounds nothing
    under flock; takeover latency is one ``renew_ms`` poll).
    """

    def __init__(self, path: str, contender_id: Optional[str] = None,
                 lease_ms: int = 1000, renew_ms: int = 200):
        self.path = path
        self.contender_id = contender_id or uuid.uuid4().hex[:12]
        self.lease_ms = lease_ms
        self.renew_ms = renew_ms
        self.is_leader = False
        self._listeners: List[Callable[[bool], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fd: Optional[int] = None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def add_listener(self, fn: Callable[[bool], None]) -> None:
        self._listeners.append(fn)

    def _notify(self, leading: bool) -> None:
        if leading != self.is_leader:
            self.is_leader = leading
            for fn in self._listeners:
                fn(leading)

    def _campaign_once(self) -> bool:
        import fcntl

        if self._fd is not None:
            # still holding the lock; refresh the observability heartbeat
            try:
                os.lseek(self._fd, 0, os.SEEK_SET)
                os.truncate(self._fd, 0)
                os.write(self._fd, json.dumps(
                    {"leader": self.contender_id, "ts": time.time()}).encode())
            except OSError:
                pass
            return True
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            return False
        self._fd = fd
        return True

    def start(self) -> "FileLeaderElection":
        def run():
            while not self._stop.is_set():
                try:
                    self._notify(self._campaign_once())
                except OSError:
                    self._notify(False)
                self._stop.wait(self.renew_ms / 1000.0)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name=f"leader-{self.contender_id}")
        self._thread.start()
        return self

    def stop(self, abdicate: bool = True) -> None:
        """``abdicate`` releases the lock (clean handover); either way the
        kernel would release it when the process/fd dies."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._fd is not None:
            import fcntl

            try:
                if abdicate:
                    fcntl.flock(self._fd, fcntl.LOCK_UN)
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None
        self._notify(False)


class LeaseLeaderElection:
    """CROSS-HOST leader election over the object-store lease service
    (``runtime/checkpoint/objectstore.py``) — the ZooKeeper/etcd analog the
    file lease cannot provide: any number of contenders on any machines
    campaign through one shared service; at most one holds the TTL lease;
    the **fencing token** (monotone per grant) lets downstream stores
    reject a deposed leader's stale writes (the classic split-brain guard).

    Same interface as :class:`FileLeaderElection`: ``start``/``stop``,
    ``is_leader``, ``add_listener(fn(bool))``; plus ``fencing_token``.
    k8s deployment: point every coordinator pod at the same objectstore
    Service and gate job submission on leadership."""

    def __init__(self, url: str, election: str = "coordinator",
                 contender_id: Optional[str] = None,
                 lease_ms: int = 2000, renew_ms: int = 500):
        from flink_tpu_torch.runtime.checkpoint.objectstore import ObjectStoreClient

        self.client = ObjectStoreClient(url)
        self.election = election
        self.contender_id = contender_id or uuid.uuid4().hex[:12]
        self.lease_ms = lease_ms
        self.renew_ms = renew_ms
        self.is_leader = False
        self.fencing_token: Optional[int] = None
        self._listeners: List[Callable[[bool], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add_listener(self, fn: Callable[[bool], None]) -> None:
        self._listeners.append(fn)

    def _notify(self, leading: bool) -> None:
        if leading != self.is_leader:
            self.is_leader = leading
            for fn in self._listeners:
                fn(leading)

    def _post(self, verb: str, body: Dict[str, Any]) -> Dict[str, Any]:
        with self.client._req("POST", f"/lease/{self.election}/{verb}",
                              json.dumps(body).encode()) as r:
            return json.loads(r.read())

    def _campaign_once(self) -> bool:
        # ANY transport/parse failure means "cannot prove leadership":
        # urllib raises http.client exceptions and ValueError besides
        # OSError, and an uncaught one would kill the campaign thread with
        # is_leader frozen True — the exact split-brain this class prevents
        try:
            if self.fencing_token is not None:
                res = self._post("renew", {"holder": self.contender_id,
                                           "token": self.fencing_token,
                                           "ttl_ms": self.lease_ms})
                if res.get("renewed"):
                    return True
                self.fencing_token = None  # lease lost: must re-acquire
            res = self._post("acquire", {"holder": self.contender_id,
                                         "ttl_ms": self.lease_ms})
            if res.get("acquired"):
                self.fencing_token = int(res["token"])
                return True
            return False
        except Exception:  # noqa: BLE001 — fail toward "not leader"
            self.fencing_token = None
            return False

    def start(self) -> "LeaseLeaderElection":
        def run():
            while not self._stop.is_set():
                leading = self._campaign_once()
                if self._stop.is_set():
                    break  # stop() already notified False: never overwrite
                self._notify(leading)
                self._stop.wait(self.renew_ms / 1000.0)

        self._thread = threading.Thread(
            target=run, daemon=True, name=f"lease-leader-{self.contender_id}")
        self._thread.start()
        return self

    def stop(self, abdicate: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            # outwait a campaign blocked in the HTTP round-trip: the run
            # loop re-checks _stop after _campaign_once, so once joined no
            # further _notify can race this one
            self._thread.join(timeout=self.client.timeout_s + 5)
        if abdicate and self.fencing_token is not None:
            try:
                self._post("release", {"holder": self.contender_id,
                                       "token": self.fencing_token})
            except Exception:  # noqa: BLE001
                pass
        self.fencing_token = None
        self._notify(False)


class HaServices:
    """Durable job metadata (``JobGraphStore`` + ``CompletedCheckpointStore``
    pointer analog): the NEW leader reads what the old one persisted."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _p(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def persist_job(self, job_id: str, payload: Dict[str, Any]) -> None:
        import pickle
        tmp = self._p(f"job-{job_id}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(payload, f)
        os.replace(tmp, self._p(f"job-{job_id}.pkl"))

    def load_job(self, job_id: str) -> Optional[Dict[str, Any]]:
        from flink_tpu_torch.runtime.checkpoint.storage import loads
        try:
            with open(self._p(f"job-{job_id}.pkl"), "rb") as f:
                return loads(f.read())
        except FileNotFoundError:
            return None

    def job_ids(self) -> List[str]:
        return sorted(f[4:-4] for f in os.listdir(self.directory)
                      if f.startswith("job-") and f.endswith(".pkl"))

    def remove_job(self, job_id: str) -> None:
        try:
            os.remove(self._p(f"job-{job_id}.pkl"))
        except FileNotFoundError:
            pass

    def set_latest_checkpoint(self, job_id: str, checkpoint_id: int) -> None:
        tmp = self._p(f"ckpt-{job_id}.tmp")
        with open(tmp, "w") as f:
            json.dump({"checkpoint_id": checkpoint_id}, f)
        os.replace(tmp, self._p(f"ckpt-{job_id}.json"))

    def latest_checkpoint(self, job_id: str) -> Optional[int]:
        try:
            with open(self._p(f"ckpt-{job_id}.json")) as f:
                return json.load(f)["checkpoint_id"]
        except (FileNotFoundError, ValueError, KeyError):
            return None

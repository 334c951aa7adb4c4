"""Coordinator high availability: leader lease, epoch fencing, job recovery
(port of ``flink_tpu/runtime/ha.py``: the records are byte for byte
JAX's, so a store directory either package wrote serves the other).

Analog of the reference's ZooKeeper HA services
(``ZooKeeperLeaderElectionDriver`` + ``DefaultCompletedCheckpointStore`` +
``JobGraphStore``): a durable :class:`FileHaStore` holds

  * a **leader lease** with a monotone **leader epoch** — the fencing
    token every control message carries (``JobMasterId`` analog).  A
    new/standby coordinator acquires the lease at ``epoch + 1``; workers
    and the store itself reject traffic from any lower epoch, so a
    zombie ex-leader can never complete a checkpoint, commit a 2PC
    transaction, or deploy a second incarnation over the new leader's;
  * the **registered job plans** (serialized payloads — what the new
    leader redeploys);
  * the **completed-checkpoint pointer** per job — the authoritative
    "latest completed cut" consulted BEFORE any ``load_latest``
    directory scan on recovery.

Durability discipline is the repo's S1 standard
(``FileCheckpointStorage`` / ``IncrementalCheckpointStorage``): every
record is staged to a tmp file and published by one atomic
``os.replace``, carries its own CRC32, and a torn/corrupt record reads
as *absent* (lease) or raises loudly (job payload) — never as silently
wrong data.

Epoch monotonicity does NOT depend on the lease file surviving: a
separate ``epoch.json`` counter is bumped (and published) BEFORE each
acquisition's lease write, so even a lease torn by a crash or an
injected ``ha.lease`` truncation cannot hand two leaders the same
epoch.  Lease renewal verifies its own write back (re-read + CRC): a
renewal that did not durably land raises :class:`LeaseLostError` — the
holder demotes LOUDLY instead of limping into dual leadership.
"""

from __future__ import annotations

import json
import os
import pickle
import threading
import time
import zlib
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

from flink_tpu_torch.runtime.checkpoint.storage import loads
from flink_tpu_torch.testing import chaos


class StaleEpochError(RuntimeError):
    """A fenced write: the acting epoch is older than the store's
    authoritative leader epoch (or than an already-published record's).
    The caller is a zombie ex-leader and must stand down."""


class LeaseLostError(RuntimeError):
    """The holder's lease is no longer its own (superseded, corrupt, or a
    renewal failed to land durably).  Raised on the renew path so the
    ex-leader demotes loudly instead of acting on stale authority."""


@dataclass(frozen=True)
class Lease:
    """One acquired leadership grant.  ``deadline`` is wall-clock unix
    seconds — cross-process comparable, unlike a monotonic clock."""

    epoch: int
    holder: str
    deadline: float


def _wall() -> float:
    return time.time()


def _crc_payload(record: Dict[str, Any]) -> bytes:
    return json.dumps(record, sort_keys=True).encode()


class FileHaStore:
    """File-backed HA services: lease + job registry + checkpoint pointer.

    Single-host scope (matching ``ProcessCluster``'s deployment model):
    atomic renames give record-level atomicity across processes; the
    in-process lock serializes same-process contenders (the scenario
    harness runs leader and standby in one process)."""

    LEASE_FILE = "lease.json"
    EPOCH_FILE = "epoch.json"

    def __init__(self, directory: str,
                 clock: Callable[[], float] = _wall):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._clock = clock
        self._lock = threading.RLock()

    # -- low-level records ---------------------------------------------------
    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _write_record(self, name: str, record: Dict[str, Any],
                      chaos_point: Optional[str] = None) -> None:
        payload = _crc_payload(record)
        keep = len(payload)
        if chaos_point is not None:
            # fault point (``ha.lease``): a TruncatedWrite schedule tears
            # the published record short — the CRC gate below turns that
            # into "record absent", and renew's verify-back into a loud
            # LeaseLostError demotion
            keep = chaos.truncated(chaos_point, len(payload))
        doc = json.dumps({"record": json.loads(payload.decode()),
                          "crc32": zlib.crc32(payload),
                          "size": len(payload)})
        data = doc.encode()[:max(0, len(doc) - (len(payload) - keep))] \
            if keep < len(payload) else doc.encode()
        tmp = self._path("." + name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, self._path(name))

    def _read_record(self, name: str) -> Optional[Dict[str, Any]]:
        """The verified record, or None when missing/torn/corrupt (a
        broken record is indistinguishable from no record — callers act
        on the intact epoch counter instead)."""
        try:
            with open(self._path(name), "rb") as f:
                doc = json.loads(f.read().decode())
        except (OSError, ValueError, UnicodeDecodeError):
            return None
        record = doc.get("record")
        if not isinstance(record, dict):
            return None
        payload = _crc_payload(record)
        if doc.get("size") != len(payload) or \
                doc.get("crc32") != zlib.crc32(payload):
            return None
        return record

    # -- leader epoch --------------------------------------------------------
    def current_epoch(self) -> int:
        """The authoritative leader epoch: max of the monotone counter
        and any intact lease record (either alone survives a torn write
        of the other)."""
        with self._lock:
            counter = self._read_record(self.EPOCH_FILE) or {}
            lease = self._read_record(self.LEASE_FILE) or {}
            return max(int(counter.get("epoch", 0)),
                       int(lease.get("epoch", 0)))

    # -- lease lifecycle -----------------------------------------------------
    def read_lease(self) -> Optional[Lease]:
        rec = self._read_record(self.LEASE_FILE)
        if rec is None:
            return None
        try:
            return Lease(int(rec["epoch"]), str(rec["holder"]),
                         float(rec["deadline"]))
        except (KeyError, TypeError, ValueError):
            return None

    def try_acquire(self, holder: str, ttl_s: float) -> Optional[Lease]:
        """Acquire leadership at ``current_epoch + 1`` — None while a
        live foreign lease holds.  The epoch counter publishes BEFORE the
        lease, so a crash between the two wastes an epoch number but can
        never mint a duplicate."""
        with self._lock:
            now = self._clock()
            live = self.read_lease()
            if live is not None and live.holder != holder \
                    and live.deadline > now:
                return None
            epoch = self.current_epoch() + 1
            self._write_record(self.EPOCH_FILE, {"epoch": epoch})
            lease = Lease(epoch, holder, now + ttl_s)
            self._write_record(self.LEASE_FILE, {
                "epoch": lease.epoch, "holder": lease.holder,
                "deadline": lease.deadline})
            return lease

    def acquire(self, holder: str, ttl_s: float,
                timeout_s: float = 30.0,
                poll_s: float = 0.05) -> Lease:
        """Poll :meth:`try_acquire` until granted (standby takeover waits
        out the incumbent's TTL) or ``timeout_s`` elapses."""
        deadline = self._clock() + timeout_s
        while True:
            lease = self.try_acquire(holder, ttl_s)
            if lease is not None:
                return lease
            if self._clock() >= deadline:
                raise TimeoutError(
                    f"lease not acquired within {timeout_s}s "
                    f"(held by {self.read_lease()})")
            time.sleep(poll_s)

    def renew(self, lease: Lease, ttl_s: float) -> Lease:
        """Extend the holder's own lease.  Verifies ownership BEFORE the
        write and verifies the write back AFTER it — a superseded epoch,
        a foreign holder, or a torn renewal (the ``ha.lease`` fault
        point) all raise :class:`LeaseLostError`: loud demotion, never
        silent dual leadership."""
        with self._lock:
            on_disk = self.read_lease()
            if on_disk is None or on_disk.epoch != lease.epoch \
                    or on_disk.holder != lease.holder:
                raise LeaseLostError(
                    f"lease (epoch {lease.epoch}, holder {lease.holder!r}) "
                    f"superseded or gone: on disk {on_disk}")
            if self.current_epoch() > lease.epoch:
                raise LeaseLostError(
                    f"epoch {lease.epoch} fenced: store is at "
                    f"{self.current_epoch()}")
            renewed = replace(lease, deadline=self._clock() + ttl_s)
            self._write_record(self.LEASE_FILE, {
                "epoch": renewed.epoch, "holder": renewed.holder,
                "deadline": renewed.deadline}, chaos_point="ha.lease")
            back = self.read_lease()
            if back is None or back.epoch != renewed.epoch \
                    or back.holder != renewed.holder \
                    or back.deadline != renewed.deadline:
                raise LeaseLostError(
                    f"lease renewal did not land durably (read back "
                    f"{back}); demoting")
            return renewed

    def is_current(self, lease: Lease) -> bool:
        on_disk = self.read_lease()
        return on_disk is not None and on_disk.epoch == lease.epoch \
            and on_disk.holder == lease.holder \
            and self.current_epoch() <= lease.epoch

    def release(self, lease: Lease) -> None:
        """Voluntary stand-down: drop the lease file iff it is still this
        holder's (a successor's lease is never touched)."""
        with self._lock:
            on_disk = self.read_lease()
            if on_disk is not None and on_disk.epoch == lease.epoch \
                    and on_disk.holder == lease.holder:
                try:
                    os.remove(self._path(self.LEASE_FILE))
                except OSError:
                    pass

    # -- epoch fence ---------------------------------------------------------
    def check_epoch(self, epoch: int) -> None:
        """Raise :class:`StaleEpochError` when ``epoch`` is older than
        the store's authoritative leader epoch."""
        current = self.current_epoch()
        if epoch < current:
            raise StaleEpochError(
                f"epoch {epoch} is fenced: leader epoch is {current}")

    # -- job registry --------------------------------------------------------
    def _job_meta(self, job_id: str) -> str:
        return f"job-{job_id}.json"

    def _job_blob(self, job_id: str) -> str:
        return self._path(f"job-{job_id}.pkl")

    def register_job(self, job_id: str, payload: Any, epoch: int) -> None:
        """Persist a job's plan payload under the acting epoch.  The
        pickle publishes first, its CRC'd meta record LAST — a job entry
        is visible iff both landed."""
        with self._lock:
            self.check_epoch(epoch)
            existing = self._read_record(self._job_meta(job_id))
            if existing is not None and int(existing.get("epoch", 0)) > epoch:
                raise StaleEpochError(
                    f"job {job_id!r} already registered at epoch "
                    f"{existing['epoch']} > {epoch}")
            blob = pickle.dumps(payload, protocol=4)
            tmp = self._job_blob(job_id) + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, self._job_blob(job_id))
            self._write_record(self._job_meta(job_id), {
                "job_id": job_id, "epoch": epoch,
                "crc32": zlib.crc32(blob), "size": len(blob)})

    def load_job(self, job_id: str) -> Any:
        """The registered payload, CRC-verified; raises ``KeyError`` for
        an unknown/torn entry (the meta record is written last, so a
        half-written registration reads as absent)."""
        with self._lock:
            meta = self._read_record(self._job_meta(job_id))
            if meta is None:
                raise KeyError(f"job {job_id!r} not registered")
            try:
                with open(self._job_blob(job_id), "rb") as f:
                    blob = f.read()
            except OSError:
                raise KeyError(f"job {job_id!r}: payload missing")
            if len(blob) != meta.get("size") or \
                    zlib.crc32(blob) != meta.get("crc32"):
                raise KeyError(f"job {job_id!r}: payload corrupt "
                               f"(size/CRC mismatch)")
            # a payload the JAX package wrote loads without importing it
            return loads(blob)

    def job_ids(self) -> List[str]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("job-") and name.endswith(".json"):
                meta = self._read_record(name)
                if meta is not None:
                    out.append(str(meta["job_id"]))
        return sorted(out)

    # -- completed-checkpoint pointer ----------------------------------------
    def _ckpt_file(self, job_id: str) -> str:
        return f"ckpt-{job_id}.json"

    def set_completed_checkpoint(self, job_id: str, checkpoint_id: int,
                                 epoch: int) -> None:
        """THE zombie fence: advance the job's completed-checkpoint
        pointer under ``epoch``.  Re-verifies the store's leader epoch at
        write time — a zombie ex-leader (whose own workers still share
        its epoch and happily ack) fails HERE, before any notify-complete
        fans out, so its checkpoint never completes and its 2PC epochs
        never commit.  The pointer itself is monotone in (epoch,
        checkpoint_id): a stale racer can never roll it backwards."""
        with self._lock:
            self.check_epoch(epoch)
            prev = self._read_record(self._ckpt_file(job_id))
            if prev is not None:
                if int(prev.get("epoch", 0)) > epoch:
                    raise StaleEpochError(
                        f"job {job_id!r} pointer already at epoch "
                        f"{prev['epoch']} > {epoch}")
                if int(prev.get("epoch", 0)) == epoch and \
                        int(prev.get("checkpoint_id", -1)) > checkpoint_id:
                    return          # same leader, older cut: keep newest
            self._write_record(self._ckpt_file(job_id), {
                "job_id": job_id, "checkpoint_id": int(checkpoint_id),
                "epoch": int(epoch)})

    def completed_checkpoint(self, job_id: str) -> Optional[Dict[str, int]]:
        rec = self._read_record(self._ckpt_file(job_id))
        if rec is None:
            return None
        return {"checkpoint_id": int(rec["checkpoint_id"]),
                "epoch": int(rec["epoch"])}


class LeaseRenewer:
    """Background renewal loop for a held lease (``ttl / 3`` cadence by
    default).  A failed renewal — superseded, torn write, store gone —
    invokes ``on_lost`` exactly once and stops: the loud-demotion seam
    both coordinators hang their standing-down logic on."""

    def __init__(self, store: FileHaStore, lease: Lease, ttl_s: float,
                 interval_s: Optional[float] = None,
                 on_lost: Optional[Callable[[Exception], None]] = None):
        self.store = store
        self.ttl_s = ttl_s
        self.interval_s = interval_s if interval_s is not None else ttl_s / 3.0
        self.on_lost = on_lost
        self._lease = lease
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.lost: Optional[Exception] = None
        self._thread = threading.Thread(target=self._loop,
                                        name="ha-lease-renew", daemon=True)

    @property
    def lease(self) -> Lease:
        with self._lock:
            return self._lease

    def start(self) -> "LeaseRenewer":
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                renewed = self.store.renew(self.lease, self.ttl_s)
                with self._lock:
                    self._lease = renewed
            except Exception as e:  # noqa: BLE001 — any renew failure demotes
                self.lost = e
                if self.on_lost is not None:
                    try:
                        self.on_lost(e)
                    except Exception:  # noqa: BLE001
                        pass
                return

    def stop(self) -> None:
        """Stop renewing WITHOUT releasing the lease (a killed
        coordinator stops exactly like this: its lease times out and a
        standby takes over at epoch + 1)."""
        self._stop.set()

    def join(self, timeout: float = 5.0) -> None:
        self._thread.join(timeout)


def resolve_restore(store: Optional[FileHaStore], job_id: str,
                    checkpoint_storage: Any,
                    log: Optional[Callable[[str], None]] = None
                    ) -> Tuple[Optional[Dict[str, Any]], str]:
    """New-leader restore resolution: the HA completed-checkpoint pointer
    is TRUTH; the storage directory scan (``load_latest``) is a logged
    fallback only — the split-brain fix for a stale leader's concurrent
    retention pass racing the scan.  Increment chains resolve inside
    ``checkpoint_storage.load``.  Returns ``(snapshot_or_None, source)``
    with source one of ``"ha-pointer"``, ``"scan-fallback"``, ``"none"``."""
    say = log if log is not None else (lambda msg: None)
    pointer = store.completed_checkpoint(job_id) if store is not None else None
    if pointer is not None and checkpoint_storage is not None:
        cid = pointer["checkpoint_id"]
        try:
            return checkpoint_storage.load(cid), "ha-pointer"
        except Exception as e:  # noqa: BLE001 — corrupt/missing cut
            say(f"HA pointer checkpoint {cid} unloadable "
                f"({type(e).__name__}: {e}); falling back to directory scan")
    if checkpoint_storage is not None:
        try:
            snap = checkpoint_storage.load_latest()
        except Exception as e:  # noqa: BLE001
            say(f"load_latest scan failed ({type(e).__name__}: {e})")
            snap = None
        if snap is not None:
            if pointer is not None:
                say("restored from directory scan despite an HA pointer "
                    "(pointer cut unloadable)")
            return snap, "scan-fallback"
    return None, "none"


def job_id_for(job_ref: str) -> str:
    """A filesystem-safe HA job id from a ``module:function`` job ref."""
    return "".join(c if c.isalnum() or c in "-_" else "_" for c in job_ref)

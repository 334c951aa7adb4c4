"""Device-lane health: watchdog, failure classification, quarantine, healing
(port of ``flink_tpu/runtime/device_health.py``).

The card is a failure domain, supervised the way the reference runtime
supervises a TaskManager: **detect** a stuck or failing device dispatch,
**classify** the failure, **quarantine** the device tier process-wide when
it is wedged, **degrade** the affected operators onto their host tier
mid-job, and **heal** — a prober re-checks the card from a throwaway
subprocess and operators re-promote their state at the next
checkpoint-aligned safe point.

Why process-wide: a wedged card holds every dispatch of the process, not
just the one that hung, so one monitor guards every device lane and one
quarantine verdict is shared by all of them.

Mechanics:

- :meth:`DeviceHealthMonitor.run_guarded` runs a dispatch thunk on a
  per-caller-thread **lane thread** and waits with a bounded deadline
  derived from the measured dispatch cost (``utils/transport.py``, the sync
  calibration) times a generous multiplier, floored by ``deadline_floor_s``.
  A dispatch that misses the deadline is a **wedge**: the lane thread is
  *sacrificed* (abandoned where it blocks), a fresh lane serves later
  attempts, and the device tier is quarantined.  The caller never blocks
  unboundedly.  A CUDA launch returns before the card has run it, so the
  window operator's thunks wait on the CUDA event of the operator's
  previous guarded dispatch first (the operator's one-deep event fence):
  a kernel that never ends trips the next dispatch's deadline.
- Failures raised by the dispatch are classified: **OOM**
  (RESOURCE_EXHAUSTED / out of memory, which ``torch.cuda.OutOfMemoryError``
  says) invokes the caller's ``on_oom`` hook (the window operator forces a
  page-out through its DevicePager) and retries once; **transient**
  runtime errors retry under exponential backoff with jitter; anything
  else (shape errors, user bugs) re-raises unchanged.  Exhausted retries
  quarantine.
- Healing probes the card in a **throwaway subprocess** with its own
  process group (:func:`probe_backend_subprocess`) under exponential
  backoff — never in-process (a probe that wedges would take the runtime
  with it) and never leaving orphans (:func:`reap_process_group`: SIGTERM
  the group first, SIGKILL after a grace period).  On success the monitor
  returns HEALTHY and counts a heal; operators poll :attr:`healthy` at
  checkpoint-aligned safe points to re-promote their state.

Chaos: the lane fires the ``device.dispatch`` fault point
(:mod:`flink_tpu_torch.testing.chaos`) *before* invoking the thunk, so a
``WedgedDevice`` schedule hangs exactly where a real wedge would, without
the real dispatch ever touching device state — after the watchdog abandons
the attempt, the parked lane wakes on heal, sees the attempt was abandoned
and **skips** the thunk.  The default probe consults the same schedule
(:func:`chaos_aware_probe`), so the whole quarantine -> degrade -> heal ->
re-promote cycle runs on the CPU in tests.

The reference's trace events (``device_health.wedge``/``quarantine``/
``heal``/``salvage``) come with the port's span journal, in the runtime
stack.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import random
import re
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from flink_tpu_torch.observability import tracing
from flink_tpu_torch.testing import chaos

__all__ = [
    "WatchdogConfig", "DeviceHealthMonitor", "DeviceQuarantinedError",
    "TRANSIENT", "OOM", "WEDGE", "FATAL", "classify_failure",
    "probe_backend_subprocess", "reap_process_group", "chaos_aware_probe",
    "get_monitor", "set_monitor", "reset_monitor", "guarded_dispatch",
    "status_snapshot",
]

# failure classes
TRANSIENT = "transient"
OOM = "oom"
WEDGE = "wedge"
FATAL = "fatal"

HEALTHY = "healthy"
QUARANTINED = "quarantined"

#: substrings marking a device OOM; "oom" matches as a WORD only — a plain
#: substring check would read "boom"/"bloom" as memory pressure
_OOM_MARKERS = ("resource_exhausted", "out of memory")
_OOM_WORD = re.compile(r"\boom\b")
#: retryable infrastructure errors: absl STATUS CODES, matched
#: case-sensitively as words, so a user bug whose message merely contains
#: "internal"/"aborted"/"unknown" in prose stays FATAL
_TRANSIENT_STATUS = re.compile(
    r"\b(UNAVAILABLE|INTERNAL|ABORTED|DEADLINE_EXCEEDED|UNKNOWN)\b")
_TRANSIENT_PHRASES = ("failed to connect", "connection reset",
                      "socket closed", "transient")

#: the healer's card check: one launch and a synchronize in a fresh process
PROBE_CODE = ("import torch; torch.ones(1, device='cuda').add_(1); "
              "torch.cuda.synchronize()")


class DeviceQuarantinedError(RuntimeError):
    """The device tier is quarantined: the dispatch did not (and will not)
    run.  Operators catch this to degrade onto their host tier; tasks
    without a host tier fail and take the normal restart path."""


def classify_failure(exc: BaseException) -> str:
    """Map a dispatch exception to TRANSIENT / OOM / FATAL.  Conservative:
    only errors that look like infrastructure failures are retryable —
    a shape mismatch or user bug must surface unchanged."""
    raw = f"{type(exc).__name__}: {exc}"
    msg = raw.lower()
    if any(m in msg for m in _OOM_MARKERS) or _OOM_WORD.search(msg):
        return OOM
    if isinstance(exc, chaos.InjectedFault):
        # injected faults default to transient unless their message says
        # otherwise (FailTimes(message=...) steers the classifier)
        return TRANSIENT
    # deliberately NO blanket match on the runtime's error type: it wraps
    # deterministic user bugs too — only the infrastructure STATUS CODES
    # are retryable
    if _TRANSIENT_STATUS.search(raw) \
            or any(p in msg for p in _TRANSIENT_PHRASES):
        return TRANSIENT
    return FATAL


# ---------------------------------------------------------------------------
# subprocess probe + process-group reaping
# ---------------------------------------------------------------------------

def reap_process_group(proc, term_grace_s: float = 30.0,
                       kill_grace_s: float = 10.0) -> None:
    """Terminate a probe and its WHOLE process group (a CUDA client may
    fork helpers; killing only the leader would leave orphans holding the
    card).  SIGTERM first, SIGKILL after ``term_grace_s``."""
    import signal

    def _signal_group(sig):
        try:
            os.killpg(proc.pid, sig)  # probe runs as its own session leader
        except (ProcessLookupError, PermissionError, OSError):
            try:
                proc.send_signal(sig)
            except Exception:  # noqa: BLE001 — already gone
                pass

    _signal_group(signal.SIGTERM)
    try:
        proc.wait(timeout=term_grace_s)
    except Exception:  # noqa: BLE001 — subprocess.TimeoutExpired
        _signal_group(signal.SIGKILL)
        try:
            proc.wait(timeout=kill_grace_s)
        except Exception:  # noqa: BLE001
            pass


def probe_backend_subprocess(timeout_s: float = 180.0) -> bool:
    """One throwaway-subprocess card probe (own process group): True iff a
    launch on ``cuda`` and a synchronize succeed within the timeout.  False
    where no GPU is visible (the probe raises there): a CPU is never
    reported as a healthy card.  The probe lives in a subprocess because a
    wedged card hangs the caller — a timed-out probe is reaped, group and
    all."""
    import subprocess
    proc = subprocess.Popen(
        [sys.executable, "-c", PROBE_CODE],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        start_new_session=True)
    try:
        return proc.wait(timeout=timeout_s) == 0
    except subprocess.TimeoutExpired:
        reap_process_group(proc)
        return False


def chaos_aware_probe(timeout_s: float = 180.0) -> bool:
    """Default healer probe.  When a chaos schedule owns the
    ``device.dispatch`` point, its wedge state IS the device's health —
    consult it (deterministic, no subprocess) so the full heal cycle runs
    on the CPU in tests.  Otherwise, the real subprocess probe."""
    inj = chaos.active()
    if inj is not None and inj.has_schedule("device.dispatch"):
        return not chaos.blocked("device.dispatch")
    return probe_backend_subprocess(timeout_s)


# ---------------------------------------------------------------------------
# monitor
# ---------------------------------------------------------------------------

@dataclass
class WatchdogConfig:
    #: hard deadline floor for one dispatch (seconds); the measured per-MB
    #: dispatch cost raises it, never lowers it below this.  Read from
    #: FLINK_TPU_WATCHDOG_FLOOR_S at CONSTRUCTION time, not import
    deadline_floor_s: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "FLINK_TPU_WATCHDOG_FLOOR_S", "120")))
    #: deadline = max(floor, measured_ms_per_mb * mb * multiplier)
    deadline_multiplier: float = 20.0
    #: the FIRST guarded dispatch (and any the caller marks) additionally
    #: gets this grace: it carries nvcc builds and first allocations, which
    #: must not read as a wedge
    first_dispatch_grace_s: float = 300.0
    #: a successful dispatch slower than this fraction of its deadline
    #: counts a watchdog NEAR MISS (the early-warning gauge)
    near_miss_frac: float = 0.5
    #: transient-error retry budget per guarded call
    max_transient_retries: int = 3
    backoff_initial_s: float = 0.05
    backoff_multiplier: float = 2.0
    backoff_max_s: float = 2.0
    #: jitter fraction applied to each backoff sleep (decorrelates retry
    #: storms across task threads)
    backoff_jitter_frac: float = 0.25
    #: background healer probe cadence (exponential from initial to max)
    probe_backoff_initial_s: float = 0.5
    probe_backoff_max_s: float = 30.0
    probe_timeout_s: float = 180.0


class _Attempt:
    __slots__ = ("fn", "done", "result", "error", "abandoned",
                 "fire_chaos")

    def __init__(self, fn, fire_chaos: bool = True):
        self.fn = fn
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.abandoned = False
        #: salvage reads skip the ``device.dispatch`` fault point: the chaos
        #: wedge models a hung DISPATCH, and the migration's state download
        #: must be drivable in the simulation (a REAL wedge hangs the read
        #: itself — the salvage deadline covers it)
        self.fire_chaos = fire_chaos


class _Lane:
    """One sacrificial dispatch thread.  The guarded call submits an
    attempt and waits with a deadline; a wedged attempt is abandoned in
    place (``die()``), and the owner creates a fresh lane.  The chaos
    ``device.dispatch`` point fires ON the lane, before the thunk — an
    abandoned attempt that later unwedges skips its thunk, so a
    quarantine-migrated operator's device state is never touched behind
    its back."""

    def __init__(self, name: str):
        self._q: "queue.Queue[Optional[_Attempt]]" = queue.Queue()
        self._dead = False
        self._t = threading.Thread(target=self._loop, daemon=True,
                                   name=name)
        self._t.start()

    def _loop(self) -> None:
        while True:
            att = self._q.get()
            if att is None:
                return
            try:
                if att.fire_chaos:
                    chaos.fire("device.dispatch")
                if not att.abandoned:
                    att.result = att.fn()
            except BaseException as e:  # noqa: BLE001 — handed to the waiter
                att.error = e
            finally:
                att.done.set()
            # the thread waits for the next attempt holding no reference to
            # this one: its thunk holds the operator, whose device state a
            # finished job must be able to free
            att = None
            if self._dead:
                return

    def submit(self, fn, fire_chaos: bool = True) -> _Attempt:
        att = _Attempt(fn, fire_chaos=fire_chaos)
        self._q.put(att)
        return att

    def die(self) -> None:
        """Abandon the lane where it blocks (sacrificial thread)."""
        self._dead = True
        self._q.put(None)   # if it ever drains, it exits


class DeviceHealthMonitor:
    """Supervision of the process's device tier — see module docstring.

    Thread-safe; one instance is shared process-wide (``get_monitor``).
    ``probe_fn`` and ``sleep`` are injectable for tests; ``heal_async``
    False disables the background healer (the owner drives
    :meth:`probe_now` itself)."""

    def __init__(self, config: Optional[WatchdogConfig] = None,
                 probe_fn: Optional[Callable[[], bool]] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 heal_async: bool = True):
        self.config = config or WatchdogConfig()
        self.probe_fn = probe_fn or (
            lambda: chaos_aware_probe(self.config.probe_timeout_s))
        self._sleep = sleep
        self.heal_async = heal_async
        self._lock = threading.Lock()
        self._state = HEALTHY
        #: caller thread ident -> (owning thread, its lane); pruned on
        #: lookup when the owning thread died, so long-lived processes
        #: running many jobs don't accumulate parked lane threads
        self._lanes: Dict[int, tuple] = {}
        self._healer: Optional[threading.Thread] = None
        self._rng = random.Random(0xD15EA5E)
        self.last_failure: Optional[str] = None
        self.counters: Dict[str, int] = {
            "dispatches": 0, "quarantines": 0, "heals": 0,
            "watchdog_timeouts": 0, "transient_retries": 0,
            "oom_pageouts": 0, "near_misses": 0, "probe_attempts": 0,
        }
        #: guarded dispatches per label (e.g. "win.fused_scan"): which
        #: dispatch site a dispatches-per-batch change came from
        self.label_counts: Dict[str, int] = {}

    # -- state ---------------------------------------------------------------
    @property
    def state(self) -> str:
        return self._state

    @property
    def healthy(self) -> bool:
        return self._state == HEALTHY

    @property
    def quarantined(self) -> bool:
        return self._state == QUARANTINED

    def status(self) -> Dict[str, Any]:
        """Monitoring view: state, last failure, floor, per-label dispatch
        counts and every counter."""
        with self._lock:
            return {"state": self._state,
                    "last_failure": self.last_failure,
                    "deadline_floor_s": self.config.deadline_floor_s,
                    "dispatch_labels": dict(self.label_counts),
                    **dict(self.counters)}

    # -- watchdog ------------------------------------------------------------
    def deadline_s(self, mb: float = 0.0) -> float:
        """Dispatch deadline: measured cost (the sync calibration,
        ``transport.dispatch_ms_per_mb``) x generous multiplier, floored."""
        from flink_tpu_torch.utils import transport
        per_mb = transport.dispatch_ms_per_mb()
        measured = 0.0
        if per_mb is not None and mb > 0:
            measured = per_mb * mb * self.config.deadline_multiplier / 1e3
        return max(self.config.deadline_floor_s, measured)

    def _lane(self) -> _Lane:
        cur = threading.current_thread()
        with self._lock:
            for tid, (thr, lane) in list(self._lanes.items()):
                if not thr.is_alive():
                    del self._lanes[tid]
                    lane.die()
            ent = self._lanes.get(cur.ident)
            if ent is None:
                lane = _Lane(f"device-lane-{len(self._lanes)}")
                self._lanes[cur.ident] = (cur, lane)
                return lane
            return ent[1]

    def _replace_lane(self) -> None:
        tid = threading.get_ident()
        with self._lock:
            ent = self._lanes.pop(tid, None)
        if ent is not None:
            ent[1].die()

    def run_guarded(self, fn: Callable[[], Any], mb: float = 0.0,
                    on_oom: Optional[Callable[[], None]] = None,
                    label: str = "dispatch",
                    compile_grace: bool = False) -> Any:
        """Run one device dispatch under the watchdog.  Returns ``fn()``'s
        result; raises :class:`DeviceQuarantinedError` when the tier is
        (or becomes) quarantined; re-raises FATAL errors unchanged.

        ``compile_grace``: the caller knows this dispatch is the first of a
        new geometry (state growth, a new operator's first batch: a build or
        a first allocation), so the deadline is raised to the grace."""
        if self.quarantined:
            raise DeviceQuarantinedError(
                f"device tier quarantined ({self.last_failure})")
        deadline = self.deadline_s(mb)
        backoff = self.config.backoff_initial_s
        retries = 0
        oom_retries = 0
        while True:
            with self._lock:
                self.counters["dispatches"] += 1
                self.label_counts[label] = \
                    self.label_counts.get(label, 0) + 1
                if compile_grace or self.counters["dispatches"] == 1:
                    deadline = max(deadline,
                                   self.config.first_dispatch_grace_s)
            lane = self._lane()
            att = lane.submit(fn)
            t0 = time.monotonic()
            if not att.done.wait(timeout=deadline):
                # WEDGE: sacrifice the lane, quarantine the tier
                att.abandoned = True
                self._replace_lane()
                with self._lock:
                    self.counters["watchdog_timeouts"] += 1
                tracing.instant("device_health.wedge", cat="device_health",
                                label=label, deadline_s=round(deadline, 1))
                self._quarantine(f"{label} exceeded {deadline:.1f}s "
                                 f"watchdog deadline (wedged)")
                raise DeviceQuarantinedError(
                    f"device tier quarantined ({self.last_failure})")
            elapsed = time.monotonic() - t0
            if att.error is None:
                if elapsed > deadline * self.config.near_miss_frac:
                    with self._lock:
                        self.counters["near_misses"] += 1
                return att.result
            kind = classify_failure(att.error)
            if kind == FATAL:
                raise att.error
            if kind == OOM and on_oom is not None and oom_retries == 0:
                oom_retries += 1
                with self._lock:
                    self.counters["oom_pageouts"] += 1
                on_oom()        # forced page-out frees memory; retry once
                continue
            # TRANSIENT (or OOM without a pressure valve): backoff + retry
            if retries >= self.config.max_transient_retries:
                self._quarantine(
                    f"{label} failed {retries + 1}x "
                    f"({type(att.error).__name__}: {att.error})")
                raise DeviceQuarantinedError(
                    f"device tier quarantined ({self.last_failure})")
            retries += 1
            with self._lock:
                self.counters["transient_retries"] += 1
                jitter = 1.0 + self.config.backoff_jitter_frac * \
                    (2.0 * self._rng.random() - 1.0)
            self._sleep(backoff * jitter)
            backoff = min(backoff * self.config.backoff_multiplier,
                          self.config.backoff_max_s)

    def run_salvage(self, fn: Callable[[], Any],
                    deadline_s: Optional[float] = None,
                    label: str = "salvage") -> Any:
        """Bounded best-effort device READ while (or after) quarantining —
        the tier migration's state download.  Unlike :meth:`run_guarded` it
        runs even when quarantined, never retries, and never re-counts a
        quarantine: on deadline the lane is sacrificed and the caller falls
        back to checkpoint recovery.  A REAL wedge hangs the read and trips
        the deadline; the chaos wedge pins only the dispatch fault point,
        so a salvage (which skips it) completes and the degrade path stays
        drivable on the CPU.

        Default deadline: the compile-grace bound, not the dispatch floor
        — a last-ditch state rescue prefers bounded-but-generous over
        tight-but-lossy."""
        deadline = (max(self.config.deadline_floor_s,
                        self.config.first_dispatch_grace_s)
                    if deadline_s is None else deadline_s)
        t0 = time.perf_counter_ns()
        lane = self._lane()
        att = lane.submit(fn, fire_chaos=False)
        done = att.done.wait(timeout=deadline)
        tracing.complete("device_health.salvage", t0,
                         time.perf_counter_ns(), cat="device_health",
                         label=label, completed=bool(done))
        if not done:
            att.abandoned = True
            self._replace_lane()
            with self._lock:
                self.counters["watchdog_timeouts"] += 1
            raise DeviceQuarantinedError(
                f"{label}: device unresponsive during state salvage "
                f"({deadline:.1f}s)")
        if att.error is not None:
            raise att.error
        return att.result

    # -- quarantine / healing ------------------------------------------------
    def _quarantine(self, reason: str) -> None:
        start_healer = False
        with self._lock:
            if self._state != QUARANTINED:
                self._state = QUARANTINED
                self.counters["quarantines"] += 1
                start_healer = self.heal_async
                tracing.instant("device_health.quarantine",
                                cat="device_health", reason=reason)
            self.last_failure = reason
        if start_healer:
            self._start_healer()

    def quarantine(self, reason: str) -> None:
        """Externally observed wedge (e.g. a failed pre-flight probe): the
        same transition the watchdog takes."""
        self._quarantine(reason)

    def probe_now(self) -> bool:
        """One synchronous probe; flips the tier back to HEALTHY (and
        counts a heal) on success.  The healer thread calls this on a
        backoff loop; tests and drivers call it directly."""
        with self._lock:
            self.counters["probe_attempts"] += 1
        ok = False
        try:
            ok = bool(self.probe_fn())
        except Exception:  # noqa: BLE001 — a crashing probe is a failed probe
            ok = False
        if ok:
            with self._lock:
                if self._state == QUARANTINED:
                    self._state = HEALTHY
                    self.counters["heals"] += 1
                    tracing.instant("device_health.heal",
                                    cat="device_health")
        return ok

    def probe_with_backoff(self, attempts: int = 2,
                           backoff_s: Optional[float] = None,
                           on_retry: Optional[Callable[[int, float],
                                                       None]] = None) -> bool:
        """Bounded synchronous probe-retry: probe, back off, re-probe.
        ``on_retry(attempt_no, backoff_s)`` is called before each backoff
        sleep (progress logging)."""
        backoff = (self.config.probe_backoff_initial_s
                   if backoff_s is None else backoff_s)
        for i in range(max(1, attempts)):
            if self.probe_now():
                return True
            if i + 1 < attempts:
                if on_retry is not None:
                    on_retry(i + 1, backoff)
                self._sleep(backoff)
                backoff = min(backoff * 2, self.config.probe_backoff_max_s)
        return False

    def _start_healer(self) -> None:
        with self._lock:
            if self._healer is not None and self._healer.is_alive():
                return
            self._healer = threading.Thread(target=self._heal_loop,
                                            daemon=True,
                                            name="device-healer")
            self._healer.start()

    def _heal_loop(self) -> None:
        backoff = self.config.probe_backoff_initial_s
        while self.quarantined:
            if self.probe_now():
                return
            self._sleep(backoff)
            backoff = min(backoff * 2, self.config.probe_backoff_max_s)


# ---------------------------------------------------------------------------
# process-wide monitor
# ---------------------------------------------------------------------------

_MONITOR: Optional[DeviceHealthMonitor] = None
_MONITOR_LOCK = threading.Lock()


def get_monitor(create: bool = True) -> Optional[DeviceHealthMonitor]:
    """The process-wide monitor (lazily created).  Disabled entirely with
    ``FLINK_TPU_DEVICE_WATCHDOG=off`` — :func:`guarded_dispatch` then runs
    dispatches inline, unguarded."""
    global _MONITOR
    if os.environ.get("FLINK_TPU_DEVICE_WATCHDOG", "").lower() in (
            "off", "0", "false"):
        return None
    with _MONITOR_LOCK:
        if _MONITOR is None and create:
            _MONITOR = DeviceHealthMonitor()
        return _MONITOR


def set_monitor(monitor: Optional[DeviceHealthMonitor]) -> None:
    global _MONITOR
    with _MONITOR_LOCK:
        _MONITOR = monitor


def reset_monitor() -> None:
    set_monitor(None)


def guarded_dispatch(fn: Callable[[], Any], mb: float = 0.0,
                     on_oom: Optional[Callable[[], None]] = None,
                     label: str = "dispatch",
                     compile_grace: bool = False) -> Any:
    """Run ``fn`` under the process-wide monitor — a queue handoff to the
    caller's lane thread plus an Event wait per dispatch.  With the
    watchdog disabled (``FLINK_TPU_DEVICE_WATCHDOG=off``) the thunk runs
    inline and UNGUARDED, but the chaos fault point still fires — disabling
    the watchdog must not silently disarm an injected schedule."""
    mon = get_monitor()
    if mon is None:
        chaos.fire("device.dispatch")
        return fn()
    return mon.run_guarded(fn, mb=mb, on_oom=on_oom, label=label,
                           compile_grace=compile_grace)


def status_snapshot() -> Dict[str, Any]:
    """Status of the process-wide monitor — HEALTHY defaults when no
    monitor exists yet."""
    mon = get_monitor(create=False)
    if mon is None:
        return {"state": HEALTHY, "last_failure": None, "quarantines": 0,
                "heals": 0, "watchdog_timeouts": 0, "transient_retries": 0,
                "oom_pageouts": 0, "near_misses": 0, "dispatches": 0,
                "probe_attempts": 0, "dispatch_labels": {}}
    return mon.status()

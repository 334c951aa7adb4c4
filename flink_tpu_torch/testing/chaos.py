"""Seeded, deterministic fault injection for the device watchdog (port of
the device part of ``flink_tpu/testing/chaos.py``).

The runtime exposes **named fault points**; the device lane's is
``device.dispatch``, fired by :mod:`flink_tpu_torch.runtime.device_health`
on the lane thread before each guarded dispatch.  Each point is a
near-zero-cost :func:`fire` call that consults the installed
:class:`FaultInjector`.  Tests attach *schedules* (fail-K-times-then-succeed,
an explicit action script, a wedge held until healed) to points and get a
reproducible failure sequence: the schedules are keyed by per-point firing
counters (and per-point RNGs derived from the injector seed), so the same
seed and schedules give the same action history on every run and in both
packages.

Usage::

    inj = FaultInjector(seed=7)
    inj.inject("device.dispatch", FailTimes(2))
    with installed(inj):
        op.process_batch(batch)
    assert inj.history("device.dispatch")[:2] == ["fail", "fail"]

This copy holds what the watchdog and its tests use.  The other schedules
(partitions, slow disks, clock skew, kill schedules, truncated writes) and
the TCP-level ``FreezableProxy`` come with the runtime stack.  Standard
library only.
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple, Union

__all__ = [
    "InjectedFault", "FaultSchedule", "FailTimes", "ActionSequence",
    "WedgedDevice", "FaultInjector", "install", "uninstall", "installed",
    "fire", "active", "blocked",
]

#: actions a schedule may return for one firing
OK = "ok"          # proceed normally
FAIL = "fail"      # raise InjectedFault at the fault point
DROP = "drop"      # suppress delivery
HANG = "hang"      # block the firing thread until the schedule heals — the
#                    wedged-accelerator model (device_health watchdog prey)
# ("delay", seconds) and ("fail", message) are the parameterized kinds
Action = Union[str, Tuple[str, float], Tuple[str, str]]


class InjectedFault(RuntimeError):
    """The error raised at a firing fault point (schedule said ``fail``)."""


class FaultSchedule:
    """Maps the 1-based firing count of a point to an action.

    Subclasses implement :meth:`action`; they must be pure functions of
    ``(n, rng)`` (plus their own construction parameters and explicit
    state transitions like :meth:`WedgedDevice.heal`) so the same seed
    yields the same failure sequence on every run."""

    def action(self, n: int, rng: random.Random) -> Action:
        raise NotImplementedError

    def dropping(self) -> bool:
        """Is the schedule in a PERSISTENT drop state right now?  Polled
        through :func:`blocked` without advancing the firing counter.
        Default False: only :class:`WedgedDevice` holds its point until
        explicitly healed."""
        return False

    def matches(self, ctx: Dict) -> bool:
        """Does this schedule apply to a firing with context ``ctx``?
        Unmatched firings proceed WITHOUT advancing the counter, RNG or
        history.  Default: every firing."""
        return True


class FailTimes(FaultSchedule):
    """Fail the first ``k`` firings, then succeed forever (retry/backoff
    must absorb exactly ``k`` errors).  ``message`` customizes the raised
    error text, which steers error CLASSIFIERS (the device-health monitor
    reads RESOURCE_EXHAUSTED as an OOM)."""

    def __init__(self, k: int, message: Optional[str] = None):
        self.k = k
        self.message = message

    def action(self, n: int, rng: random.Random) -> Action:
        if n > self.k:
            return OK
        return FAIL if self.message is None else (FAIL, self.message)


class ActionSequence(FaultSchedule):
    """Explicit per-firing script (``["ok", "fail", "fail"]``), then
    ``then`` forever — arbitrary deterministic scenarios."""

    def __init__(self, actions: Sequence[Action], then: Action = OK):
        self.actions = list(actions)
        self.then = then

    def action(self, n: int, rng: random.Random) -> Action:
        return self.actions[n - 1] if n <= len(self.actions) else self.then


class WedgedDevice(FaultSchedule):
    """Hang the firing thread from the ``at``-th firing until healed — the
    wedged-accelerator model (a device grant that is never released, so
    every later dispatch of the process blocks too).  Deterministic: firing
    ``at`` (and every later one while active) parks inside
    :meth:`FaultInjector.fire` in a ``dropping()`` poll loop; :meth:`heal`
    releases it.  The watchdog is expected to abandon the hung dispatch
    from outside long before then — the parked thread is the sacrifice."""

    def __init__(self, at: int = 1):
        self.at = at
        self._active = threading.Event()
        self._active.set()
        self._reached = threading.Event()   # a firing actually wedged

    def heal(self) -> None:
        self._active.clear()

    @property
    def healed(self) -> bool:
        return not self._active.is_set()

    @property
    def wedged_once(self) -> bool:
        """Did any firing actually park?  (Test synchronization hook.)"""
        return self._reached.is_set()

    def action(self, n: int, rng: random.Random) -> Action:
        if self._active.is_set() and n >= self.at:
            self._reached.set()
            return HANG
        return OK

    def dropping(self) -> bool:
        return self._active.is_set()


class FaultInjector:
    """Registry of fault points -> schedules with a deterministic seed.

    Each point gets its own firing counter, its own ``random.Random``
    seeded from ``f"{seed}:{point}"``, and its own action history — two
    runs with the same seed and schedules produce identical per-point
    histories no matter how unrelated threads interleave."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._lock = threading.Lock()
        self._schedules: Dict[str, FaultSchedule] = {}
        self._counts: Dict[str, int] = {}
        self._rngs: Dict[str, random.Random] = {}
        self._history: Dict[str, List[Action]] = {}

    def inject(self, point: str, schedule: FaultSchedule) -> FaultSchedule:
        """Attach ``schedule`` to ``point`` (replacing any previous one);
        returns the schedule for later control (e.g. ``WedgedDevice.heal``)."""
        with self._lock:
            self._schedules[point] = schedule
            self._counts.setdefault(point, 0)
            self._history.setdefault(point, [])
        return schedule

    def clear(self, point: Optional[str] = None) -> None:
        with self._lock:
            if point is None:
                self._schedules.clear()
            else:
                self._schedules.pop(point, None)

    def _consult(self, point: str, ctx) -> Tuple[Optional[FaultSchedule],
                                                 Action, int]:
        """One firing: match, count, draw the action, record history."""
        with self._lock:
            sched = self._schedules.get(point)
            if sched is None or not sched.matches(ctx):
                return None, OK, 0
            n = self._counts.get(point, 0) + 1
            self._counts[point] = n
            rng = self._rngs.get(point)
            if rng is None:
                rng = self._rngs[point] = random.Random(
                    f"{self.seed}:{point}")
            act = sched.action(n, rng)
            self._history.setdefault(point, []).append(act)
        return sched, act, n

    def fire(self, point: str, **ctx) -> bool:
        """Consult the point's schedule: returns True to proceed, False to
        suppress delivery (``drop``), sleeps on ``delay``, parks on
        ``hang`` until the schedule heals, raises :class:`InjectedFault`
        on ``fail``."""
        sched, act, n = self._consult(point, ctx)
        if act == OK:
            return True
        if act == DROP:
            return False
        if act == HANG:
            # wedged: park until healed — the hang itself fired exactly
            # once, so determinism survives any wedge duration
            while sched.dropping():
                time.sleep(0.005)
            return True
        if isinstance(act, tuple) and act[0] == "delay":
            time.sleep(act[1])
            return True
        if isinstance(act, tuple) and act[0] == FAIL:
            raise InjectedFault(act[1])
        raise InjectedFault(f"injected fault at {point} (firing {n}, "
                            f"ctx={ctx or {}})")

    def blocked(self, point: str, **ctx) -> bool:
        """Is the point's schedule in a persistent drop state?  Polling it
        advances no counter, RNG or history."""
        with self._lock:
            sched = self._schedules.get(point)
        return sched is not None and sched.dropping() and sched.matches(ctx)

    def history(self, point: Optional[str] = None):
        """Recorded action sequence of one point (or all points) — the
        determinism contract: compare across runs with the same seed."""
        with self._lock:
            if point is not None:
                return list(self._history.get(point, []))
            return {p: list(h) for p, h in self._history.items()}

    def fired(self, point: str) -> int:
        with self._lock:
            return self._counts.get(point, 0)

    def has_schedule(self, point: str) -> bool:
        with self._lock:
            return point in self._schedules


# ---------------------------------------------------------------------------
# global hook — the runtime's fault points call fire(); no injector = no-op
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultInjector] = None


def install(injector: FaultInjector) -> FaultInjector:
    global _ACTIVE
    _ACTIVE = injector
    return injector


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FaultInjector]:
    return _ACTIVE


@contextmanager
def installed(injector: FaultInjector):
    """``with chaos.installed(inj): ...`` — scoped installation; always
    uninstalls, so one test's faults never leak into the next."""
    install(injector)
    try:
        yield injector
    finally:
        uninstall()


def fire(point: str, **ctx) -> bool:
    """The runtime-side hook: near-zero cost when no injector is installed."""
    inj = _ACTIVE
    if inj is None:
        return True
    return inj.fire(point, **ctx)


def blocked(point: str, **ctx) -> bool:
    """Poll a held point without re-firing it (counter/RNG/history stay
    untouched)."""
    inj = _ACTIVE
    return inj is not None and inj.blocked(point, **ctx)

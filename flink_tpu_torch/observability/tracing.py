"""Structured span journal: a lock-free per-process tracing ring.

Analog of the reference's (FLIP-165 era) always-on runtime observability,
in the spirit of Dapper: instrumentation sites call :func:`span` /
:func:`instant` and pay **one module-attribute read plus a None check**
when tracing is off — the journal is a module singleton installed with
:func:`install` and every emit helper early-outs on ``_JOURNAL is None``,
so the hot paths can afford unconditional instrumentation.

Design points:

- **Lock-free bounded ring**: span slots are reserved with one
  ``next()`` on an ``itertools.count`` — a single C call, atomic under
  the GIL — so concurrent recorders never contend on a mutex and every
  reserved slot has exactly one writer; once the capacity is exhausted
  new spans are DROPPED and counted (:attr:`SpanJournal.dropped`) —
  memory stays bounded no matter how hot the instrumented site is, and
  the drop counter makes truncation loud instead of silent.
- **Timestamps**: span begin/end use ``time.perf_counter_ns`` (monotone,
  ns precision — hot-stage phases are sub-ms); the journal anchors that
  clock to wall time THROUGH the ``utils/clock.py`` seam at creation, so
  exported timelines live on the (chaos-skewable) wall clock and
  cross-process assembly can align per-worker anchors.
- **Chrome trace-event export**: :func:`to_chrome` renders a journal
  snapshot as the trace-event JSON dialect Perfetto / chrome://tracing
  load directly (``ph: "X"`` complete spans, ``ph: "i"`` instants,
  metadata events naming processes/threads).

This module imports only the standard library (plus the clock seam), so
every runtime layer can import it without cycles or import cost.

The port's copy of ``flink_tpu/observability/tracing.py`` (host Python, as JAX's).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional

from flink_tpu_torch.utils import clock

__all__ = ["SpanJournal", "install", "uninstall", "active", "enabled",
           "span", "instant", "complete", "to_chrome",
           "acquire_for_execution", "release_after_execution"]

#: default ring capacity — ~8k spans cover minutes of checkpoint/phase
#: traffic; bench --trace installs a much larger ring explicitly
DEFAULT_CAPACITY = 8192


class SpanJournal:
    """Bounded per-process ring of structured spans.

    Each entry is a tuple ``(ph, ts_ns, dur_ns, name, cat, tid, args)``
    with ``ph`` one of ``"X"`` (complete span) / ``"i"`` (instant),
    ``ts_ns`` a ``perf_counter_ns`` reading, ``tid`` the recording
    thread's name and ``args`` a small dict of scalars (or None).
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock_: Optional["clock.Clock"] = None):
        self._cap = max(1, int(capacity))
        self._clock = clock_ if clock_ is not None else clock.SYSTEM_CLOCK
        self._buf: List[Optional[tuple]] = [None] * self._cap
        #: lock-free slot reservation: ``next()`` is one atomic C call,
        #: so the reservation count is exact under concurrent recording
        self._reserve = itertools.count()
        #: wall/perf anchor pair: maps perf_counter_ns readings onto the
        #: (chaos-skewable) wall clock at export time
        self.anchor_wall_us = int(self._clock.now_ms() * 1000)
        self.anchor_perf_ns = time.perf_counter_ns()

    # -- recording ---------------------------------------------------------
    def record(self, ph: str, ts_ns: int, dur_ns: int, name: str,
               cat: str, args: Optional[Dict[str, Any]] = None) -> None:
        i = next(self._reserve)        # atomic slot reservation
        if i >= self._cap:
            return                     # full: drop, counted via _reserved
        self._buf[i] = (ph, ts_ns, dur_ns, name, cat,
                        threading.current_thread().name, args)

    def _reserved(self) -> int:
        """Total reservations so far WITHOUT consuming a slot —
        ``itertools.count`` exposes its next value only through the
        pickle protocol (``count(n).__reduce__() == (count, (n,))``).
        Cold-path reads only (properties, snapshot)."""
        return self._reserve.__reduce__()[1][0]

    def reset(self) -> None:
        """Fresh ring + drop counter + anchors: a new job execution in the
        same process starts from an empty timeline instead of inheriting
        (or being starved by) the previous job's spans.  Spans a racing
        recorder is mid-writing when reset lands may bleed into the new
        ring — one stray span beats a dead or leaked trace."""
        fresh: List[Optional[tuple]] = [None] * self._cap
        # counter first, buffer second: a racing recorder that reserved
        # from the OLD counter writes a stale high slot into whichever
        # buffer it sees — spans() skips the stale None-gaps either way
        self._reserve = itertools.count()
        self._buf = fresh
        self.anchor_wall_us = int(self._clock.now_ms() * 1000)
        self.anchor_perf_ns = time.perf_counter_ns()

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def recorded(self) -> int:
        return min(self._reserved(), self._cap)

    @property
    def dropped(self) -> int:
        return max(0, self._reserved() - self._cap)

    # -- reading -----------------------------------------------------------
    def spans(self) -> List[tuple]:
        """Recorded spans in reservation order (in-flight writes — slots
        reserved but not yet stored by another thread — are skipped)."""
        return [s for s in self._buf[:self.recorded] if s is not None]

    def snapshot(self) -> Dict[str, Any]:
        """Picklable journal dump — the unit cross-process assembly ships
        (``assembly.merge_timelines``) and exporters render."""
        return {"anchor_wall_us": self.anchor_wall_us,
                "anchor_perf_ns": self.anchor_perf_ns,
                "spans": self.spans(),
                "dropped": self.dropped,
                "capacity": self._cap}

    def summary(self) -> Dict[str, Any]:
        """Monitoring-grade rollup (``job_status()["trace"]`` backing):
        span/drop counts plus per-category tallies."""
        cats: Dict[str, int] = {}
        for s in self.spans():
            cats[s[4]] = cats.get(s[4], 0) + 1
        return {"enabled": True, "spans": self.recorded,
                "dropped": self.dropped, "capacity": self._cap,
                "categories": cats}


# ---------------------------------------------------------------------------
# module singleton + emit helpers (the instrumentation-site API)
# ---------------------------------------------------------------------------

_JOURNAL: Optional[SpanJournal] = None


def install(journal: Optional[SpanJournal] = None,
            capacity: int = DEFAULT_CAPACITY) -> SpanJournal:
    """Install ``journal`` (or a fresh ring of ``capacity``) as THE
    process journal; returns it.  Instrumentation all over the runtime
    starts recording immediately."""
    global _JOURNAL
    _JOURNAL = journal if journal is not None else SpanJournal(capacity)
    return _JOURNAL


def uninstall() -> Optional[SpanJournal]:
    """Disable tracing; returns the journal that was installed (so its
    contents can still be exported)."""
    global _JOURNAL
    j, _JOURNAL = _JOURNAL, None
    return j


def active() -> Optional[SpanJournal]:
    return _JOURNAL


def enabled() -> bool:
    return _JOURNAL is not None


def adopt_or_install(capacity: int) -> "tuple[SpanJournal, bool]":
    """Constructor-time arm of the ownership state machine (shared by
    both cluster frontends): adopt the live ring — its installer owns its
    lifetime and capacity choice — else install an owned ring of
    ``capacity``.  Unlike :func:`acquire_for_execution` this never
    resets: construction must not clear a ring another job is still
    recording into."""
    act = active()
    if act is not None:
        return act, False
    return install(capacity=int(capacity)), True


def acquire_for_execution(journal: Optional[SpanJournal], owned: bool,
                          capacity: Optional[int] = None
                          ) -> "tuple[SpanJournal, bool]":
    """Claim the process journal for one job execution; returns the
    ``(journal, owned)`` pair the run will record into and report from.

    Both cluster frontends (MiniCluster.execute, ProcessCluster.run) go
    through this one state machine so the ownership invariants live in a
    single place:

    - **own ring, singleton free or ours**: re-install (a previous
      execution released it) and reset — job B must not inherit job A's
      spans or start against A's already-consumed capacity (the ring
      drops when full, so a long-lived process would go trace-dead).
    - **own ring, FOREIGN ring live**: re-adopt the live ring — our ring
      is not the one instrumentation records into, so installing or
      reporting from it would serve a stale timeline as this job's.
    - **adopted ring, singleton free**: its owner released it — stand up
      a fresh OWNED ring (``capacity`` or the adopted ring's) instead of
      running trace-dead while reporting the stale adopted spans.
    - **adopted or foreign ring live**: (re-)adopt it; the installer
      resets/releases it, not us.
    """
    act = active()
    if owned:
        if act is None or act is journal:
            install(journal)
            journal.reset()
            return journal, True
        return act, False
    if act is None:
        if capacity is None:
            capacity = (journal.capacity if journal is not None
                        else DEFAULT_CAPACITY)
        return install(capacity=int(capacity)), True
    return act, False


def release_after_execution(journal: Optional[SpanJournal],
                            owned: bool) -> None:
    """Release an OWNED ring at execution end so the next tracing-enabled
    cluster in this process installs fresh instead of adopting (and
    reporting) this job's spans; the caller's handle keeps serving
    job_status()/trace exports afterwards.  Adopted rings are the
    installer's to release — left untouched."""
    if owned and active() is journal:
        uninstall()


class _SpanCtx:
    """``with span("name", cat=...):`` — records one complete span on
    exit; a no-op (no clock reads) when tracing is off at entry."""

    __slots__ = ("_name", "_cat", "_args", "_t0", "_j")

    def __init__(self, name: str, cat: str, args: Optional[dict]):
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._j = _JOURNAL
        if self._j is not None:
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        j = self._j
        if j is not None:
            t1 = time.perf_counter_ns()
            j.record("X", self._t0, t1 - self._t0, self._name, self._cat,
                     self._args)
        return False


def span(name: str, cat: str = "runtime", **args) -> _SpanCtx:
    """Begin/end span context manager (``ph: "X"`` complete event)."""
    return _SpanCtx(name, cat, args or None)


def instant(name: str, cat: str = "runtime", **args) -> None:
    """Point-in-time event (``ph: "i"``)."""
    j = _JOURNAL
    if j is not None:
        j.record("i", time.perf_counter_ns(), 0, name, cat, args or None)


def complete(name: str, start_ns: int, end_ns: int,
             cat: str = "runtime", **args) -> None:
    """Complete span with explicit ``perf_counter_ns`` endpoints — for
    sites that already timed themselves (phase timers, checkpoint
    trigger→complete)."""
    j = _JOURNAL
    if j is not None:
        j.record("X", start_ns, max(0, end_ns - start_ns), name, cat,
                 args or None)


# ---------------------------------------------------------------------------
# Chrome trace-event export
# ---------------------------------------------------------------------------

def to_chrome(snap: Dict[str, Any], pid: int = 0,
              process_name: str = "flink-tpu",
              offset_us: float = 0.0) -> List[Dict[str, Any]]:
    """Render a journal snapshot as Chrome trace-event dicts
    (Perfetto-loadable).  ``offset_us`` shifts this journal's wall
    timeline — cross-process assembly passes the estimated per-worker
    clock offset so every process lands on ONE job timeline."""
    wall0 = snap["anchor_wall_us"] + offset_us
    perf0 = snap["anchor_perf_ns"]
    events: List[Dict[str, Any]] = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": process_name}}]
    seen_tids: Dict[str, int] = {}
    for ph, ts_ns, dur_ns, name, cat, tname, args in snap["spans"]:
        tid = seen_tids.setdefault(tname, len(seen_tids) + 1)
        ev: Dict[str, Any] = {
            "name": name, "cat": cat, "ph": ph, "pid": pid, "tid": tid,
            "ts": round(wall0 + (ts_ns - perf0) / 1000.0, 3)}
        if ph == "X":
            ev["dur"] = round(dur_ns / 1000.0, 3)
        elif ph == "i":
            ev["s"] = "t"                  # thread-scoped instant
        if args:
            ev["args"] = dict(args)
        events.append(ev)
    for tname, tid in seen_tids.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": tname}})
    return events

"""The measured window and, in a traced run, its device trace.

:class:`Window` marks the measured window's start and end on the host
clock.  With tracing on it also runs ``torch.profiler`` (CPU and CUDA
activity) and the program's span journal over the window, and reduces them
once the window has closed (:meth:`Window.reduce`):

- **busy**: the union of the intervals in which a kernel, a copy or a
  memset ran on the device, so work that overlaps counts once;
- **device ops**: device seconds by operation name;
- **idle gaps**: the seconds in which no device operation ran, named by
  what the host was doing: the harness's own span (``batch``,
  ``watermark``, ``checkpoint``, ``job``) and inside it the program's
  phase (its ``hot_stage`` spans) or the outermost ATen op on the
  harness's thread.

The profiler's clock and ``perf_counter_ns`` are tied by an annotation the
window records at a known ``perf_counter_ns`` reading.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from portbench.lib import stats

#: trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the annotation that ties the profiler's clock to perf_counter_ns
ANCHOR = "portbench.anchor"
#: spans the program's journal may hold before it drops (a window of
#: tens of seconds records a few hundred thousand phases)
JOURNAL_CAPACITY = 1 << 21
#: entries of each breakdown list
TOP = 10


class Window:
    """The measured window of one run.  The driver calls :meth:`begin`
    just before its first timed record and :meth:`end` once the last
    record's work is done, and wraps each host step in :meth:`span`."""

    def __init__(self, trace: bool, device):
        self.trace = bool(trace)
        self.device = device
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self._prof = None
        self._journal = None
        self._anchor_ns = 0
        self._spans: List[tuple] = []

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def begin(self) -> None:
        if self.trace:
            import torch
            from flink_tpu_torch.observability import tracing
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self._journal = tracing.install(capacity=JOURNAL_CAPACITY)
            # the annotation's start lies between the two readings; the
            # first annotation of a process pays a set-up, so one goes first
            with torch.profiler.record_function(ANCHOR + ".warm"):
                pass
            before = time.perf_counter_ns()
            with torch.profiler.record_function(ANCHOR):
                self._anchor_ns = (before + time.perf_counter_ns()) // 2
        self.t0 = time.perf_counter()

    def end(self) -> None:
        sync(self.device)
        self.t1 = time.perf_counter()
        if self.trace:
            from flink_tpu_torch.observability import tracing
            tracing.uninstall()
            self._prof.__exit__(None, None, None)

    @contextlib.contextmanager
    def span(self, name: str):
        """A harness span (host clock), recorded only when tracing."""
        if not self.trace:
            yield
            return
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self._spans.append((name, t0, time.perf_counter_ns()))

    def reduce(self) -> dict:
        """The traced window reduced: ``busy_s``, ``window_s``, and
        ``device_ops`` and ``idle_gaps`` (lists of ``[name, seconds]``,
        largest first)."""
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        spans = self._journal.spans()
        return reduce_trace(
            events, self._anchor_ns, int(self.t0 * 1e9), int(self.t1 * 1e9),
            self._spans, [(s[3], s[1], s[1] + s[2]) for s in spans
                          if s[0] == "X" and s[4] == "hot_stage"])


def sync(device) -> None:
    if getattr(device, "type", None) == "cuda":
        import torch
        torch.cuda.synchronize(device)


def reduce_trace(events: list, anchor_ns: int, t0_ns: int, t1_ns: int,
                 harness_spans, phase_spans) -> dict:
    """:meth:`Window.reduce` on parsed chrome-trace ``events``; times of
    the spans are ``perf_counter_ns`` readings, ``anchor_ns`` the reading
    taken as the :data:`ANCHOR` annotation began."""
    anchor = [e for e in events
              if e.get("name") == ANCHOR and e.get("ph") == "X"
              and e.get("cat") in ("user_annotation", "cpu_op")]
    if not anchor:
        raise RuntimeError("the profiler's trace lacks the window's anchor")
    offset_us = float(anchor[0]["ts"]) - anchor_ns / 1e3

    def on_trace(ns: int) -> float:
        return ns / 1e3 + offset_us

    lo, hi = on_trace(t0_ns), on_trace(t1_ns)
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    d_s = np.array([float(e["ts"]) for e in dev], np.float64)
    d_e = d_s + np.array([float(e.get("dur", 0)) for e in dev], np.float64)
    busy_s, busy_e = stats.clip(*stats.union(d_s, d_e), lo, hi)
    by_op: Dict[str, float] = {}
    for e, s, t in zip(dev, d_s.tolist(), d_e.tolist()):
        w = min(t, hi) - max(s, lo)
        if w > 0:
            by_op[e["name"]] = by_op.get(e["name"], 0.0) + w / 1e6
    gap_s, gap_e = stats.gaps(busy_s, busy_e, lo, hi)

    # what the host did: the harness's spans, the program's phases, and
    # the outermost ATen ops on the harness's own thread
    tids = {e.get("tid") for e in anchor}
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "cpu_op" and e.get("tid") in tids]
    layers = []
    for spans in (harness_spans, phase_spans):
        if spans:
            layers.append(stats.first_level(
                np.array([on_trace(s[1]) for s in spans]),
                np.array([on_trace(s[2]) for s in spans]),
                [s[0] for s in spans]))
        else:
            layers.append((np.zeros(0), np.zeros(0), []))
    o_s = np.array([float(e["ts"]) for e in ops], np.float64)
    layers.append(stats.first_level(
        o_s, o_s + np.array([float(e.get("dur", 0)) for e in ops]),
        [e["name"] for e in ops]))
    idle = stats.attribute(gap_s, gap_e, layers)

    def top(d: dict, scale: float) -> list:
        return [[k, v * scale] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"busy_s": float((busy_e - busy_s).sum()) / 1e6,
            "window_s": (hi - lo) / 1e6,
            "device_ops": top(by_op, 1.0),
            "idle_gaps": top(idle, 1e-6)}

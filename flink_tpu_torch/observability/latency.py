"""End-to-end latency tracking from ``LatencyMarker`` flow.

Analog of the reference's ``LatencyStats`` / ``LatencyMarker`` pipeline:
sources emit markers on the ``metrics.latency.interval`` cadence (through
the injectable clock seam, so the ClockSkew nemesis covers latency
tracking like it covers timers); the markers ride the dataflow AROUND
user functions — through chains, host channels and the cross-process data
plane — and every subtask that sees one records ``now - marked_time``
into a per-``(source, source_subtask, hop)`` histogram here.  The sink
hop's histogram is therefore the end-to-end source→sink latency
distribution the paper's p99 story needs; intermediate hops decompose it
per operator.

Histograms register on a (job-scope) metric group when one is bound, so
every reporter — Prometheus summaries with ``quantile`` labels included —
exports ``latency.*`` series, alongside explicit p50/p99 gauges; the REST
latency panel and ``job_status()["latency"]`` read :meth:`panel`.

The port's copy of ``flink_tpu/observability/latency.py`` (host Python, as JAX's).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from flink_tpu_torch.metrics.core import Histogram
from flink_tpu_torch.observability import tracing
from flink_tpu_torch.utils import clock

__all__ = ["LatencyTracker", "latency_metric_name"]


def latency_metric_name(source: str, source_subtask: int, hop: str) -> str:
    """``latency.source.<src>.<i>.op.<hop>`` — the reference's
    ``latency.source_id.X.operator_id.Y.latency`` scope, readable."""
    return f"latency.source.{source}.{source_subtask}.op.{hop}"


class LatencyTracker:
    """Per-(source, operator-hop) latency histograms (``LatencyStats``)."""

    def __init__(self, clock_: Optional["clock.Clock"] = None,
                 histogram_size: int = 2048):
        self._clock = clock_ if clock_ is not None else clock.SYSTEM_CLOCK
        self._size = histogram_size
        self._lock = threading.Lock()
        self._hists: Dict[Tuple[str, int, str], Histogram] = {}
        #: hops from previous executions, cleared but still REGISTERED on
        #: the metric group — a reappearing hop must reuse its registered
        #: Histogram object (``MetricGroup._register`` keeps the first
        #: metric per name) or panel and reporters would diverge
        self._retired: Dict[Tuple[str, int, str], Histogram] = {}
        self._group = None

    # -- metric-group binding ---------------------------------------------
    def bind_group(self, group) -> "LatencyTracker":
        """Register existing and future hop histograms (+ p50/p99 gauges)
        on ``group`` so the metric reporters export them."""
        with self._lock:
            self._group = group
            for key, hist in self._hists.items():
                self._register_locked(key, hist)
        return self

    def _register_locked(self, key: Tuple[str, int, str],
                         hist: Histogram) -> None:
        if self._group is None:
            return
        base = latency_metric_name(*key)
        self._group._register(base, hist)
        self._group.gauge(f"{base}.p50_ms",
                          lambda h=hist: h.get_statistics()["p50"])
        self._group.gauge(f"{base}.p99_ms",
                          lambda h=hist: h.get_statistics()["p99"])

    # -- recording ---------------------------------------------------------
    def record(self, marker, hop: str) -> float:
        """Record one marker observation at ``hop`` (a vertex uid /
        operator name); returns the sample in ms.  Negative readings
        (clock skew between emitting and observing process) clamp to 0 —
        a latency histogram must not absorb skew as negative time."""
        now_s = self._clock.now_ms_f() / 1000.0
        lat_ms = max(0.0, (now_s - marker.marked_time) * 1000.0)
        source = getattr(marker, "source", "") or \
            f"source-{marker.source_id}"
        key = (source, int(marker.subtask_index), hop)
        # parallel subtasks of one vertex share a (source, hop) histogram
        # (markers BROADCAST to every downstream subtask), and
        # Histogram.update is a multi-step mutation — serialize it.
        # Markers flow on a ms-scale cadence, so the lock is off any hot
        # path.
        with self._lock:
            hist = self._hists.get(key)
            if hist is None:
                hist = self._retired.pop(key, None)
                if hist is None:
                    hist = Histogram(size=self._size)
                self._hists[key] = hist
                self._register_locked(key, hist)
            hist.update(lat_ms)
            n = hist.get_count()
        # timeline dots are SAMPLED 1-in-64 per hop (first sample kept):
        # the span ring fills once and never wraps, and at the documented
        # ms-scale marker cadences an instant per marker would exhaust it
        # in about a minute, starving the checkpoint/hot-stage spans the
        # trace exists for — the full distribution lives in the histogram
        if n % 64 == 1:
            tracing.instant("latency.marker", cat="latency", source=source,
                            hop=hop, latency_ms=round(lat_ms, 3))
        return lat_ms

    def reset(self) -> None:
        """Start a new execution's latency view: every hop row leaves the
        panel/summary and its samples are cleared, mirroring the span
        journal's per-execution reset — job B must not report job A's
        hops or percentiles.  The Histogram objects stay registered on
        the bound metric group (retired, cleared); a hop that reappears
        reuses its registered object so reporters and the panel keep
        reading the same reservoir."""
        with self._lock:
            for key, hist in self._hists.items():
                hist.clear()
                self._retired[key] = hist
            self._hists = {}

    # -- views -------------------------------------------------------------
    def panel(self) -> List[Dict[str, Any]]:
        """Per-hop latency rows for the REST panel /
        ``job_status()["latency"]``: source identity, hop, sample count
        and p50/p95/p99/max in ms."""
        with self._lock:
            items = sorted(self._hists.items())
        out = []
        for (source, subtask, hop), hist in items:
            s = hist.get_statistics()
            out.append({"source": source, "source_subtask": subtask,
                        "hop": hop, "count": s["count"],
                        "p50_ms": round(s["p50"], 3),
                        "p95_ms": round(s["p95"], 3),
                        "p99_ms": round(s["p99"], 3),
                        "max_ms": round(s["max"], 3)})
        return out

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            hists = list(self._hists.values())
        return {"hops": len(hists),
                "samples": sum(h.get_count() for h in hists)}

"""Observability: structured span tracing + end-to-end latency tracking.

Two cooperating layers, both cheap enough to leave on:

- :mod:`flink_tpu_torch.observability.tracing` — a per-process ring-buffer
  **span journal** (begin/end/instant events through the injectable clock
  seam, bounded memory, drop counter) with instrumentation at the
  runtime's load-bearing sites: hot-stage phases, the checkpoint
  lifecycle, device-health transitions, pager traffic, mesh exchange
  dispatch and CEP vectorized drains.  Exports Chrome trace-event JSON
  (Perfetto-viewable); :mod:`flink_tpu_torch.observability.assembly` merges
  per-worker journals into ONE job timeline with clock-offset estimation.
- :mod:`flink_tpu_torch.observability.latency` — Dapper-style always-on
  latency tracking: ``LatencyMarker`` probes emitted by sources on the
  ``metrics.latency.interval`` cadence are recorded at every operator hop
  into per-(source, hop) histograms, exported through the metric
  reporters (Prometheus summaries included) and the REST latency panel.

The port's copy of ``flink_tpu/observability/__init__.py`` (host Python, as JAX's).
"""

from flink_tpu_torch.observability.latency import LatencyTracker
from flink_tpu_torch.observability.tracing import SpanJournal

__all__ = ["SpanJournal", "LatencyTracker"]

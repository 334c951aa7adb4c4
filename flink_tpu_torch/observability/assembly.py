"""Cross-process trace assembly: per-worker journals → ONE job timeline.

Each process records spans against its own wall clock (the journal's
anchor).  To merge worker rings into the coordinator's timeline the
clocks must be aligned; the coordinator estimates each worker's offset
with the classic NTP midpoint: it stamps ``t0`` when the trace request
leaves, the worker stamps its own wall ``w`` when dumping, the
coordinator stamps ``t1`` on receipt — ``offset = w - (t0 + t1) / 2``,
accurate to half the request round trip (µs–ms on the loopback control
plane, far below the ms-scale spans being aligned).

:func:`merge_timelines` renders everything as one Chrome trace-event
JSON document (Perfetto-loadable): the coordinator is pid 0, worker ``i``
is pid ``i + 1``, and every worker's events are shifted by its estimated
offset so one "why was THIS window fire slow" question reads across
process boundaries.

The port's copy of ``flink_tpu/observability/assembly.py`` (host Python, as JAX's).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from flink_tpu_torch.observability.tracing import to_chrome

__all__ = ["estimate_offset_ms", "merge_timelines"]


def estimate_offset_ms(t0_ms: float, t1_ms: float,
                       worker_wall_ms: float) -> float:
    """Worker-clock minus coordinator-clock estimate (NTP midpoint):
    positive = the worker's wall clock runs ahead."""
    return worker_wall_ms - (t0_ms + t1_ms) / 2.0


def merge_timelines(local_snapshot: Optional[Dict[str, Any]],
                    worker_dumps: List[Tuple[int, Dict[str, Any], float]],
                    t0_ms: Optional[float] = None,
                    process_name: str = "coordinator") -> Dict[str, Any]:
    """Assemble one Chrome trace document from the coordinator's journal
    snapshot plus ``(worker_index, dump, t1_ms)`` tuples, where ``dump``
    is a worker's ``trace_dump`` payload (``journal`` snapshot +
    ``wall_now_ms`` + optional ``latency`` panel) and ``t1_ms`` the
    coordinator wall time its reply arrived.  ``t0_ms`` is the wall time
    the requests went out (one broadcast — shared by all workers)."""
    events: List[Dict[str, Any]] = []
    dropped = 0
    if local_snapshot is not None:
        events += to_chrome(local_snapshot, pid=0,
                            process_name=process_name)
        dropped += local_snapshot.get("dropped", 0)
    offsets: Dict[int, float] = {}
    latency: List[Dict[str, Any]] = []
    for idx, dump, t1_ms in sorted(worker_dumps, key=lambda d: d[0]):
        off_ms = 0.0
        if t0_ms is not None and dump.get("wall_now_ms") is not None:
            off_ms = estimate_offset_ms(t0_ms, t1_ms, dump["wall_now_ms"])
        offsets[idx] = round(off_ms, 3)
        snap = dump.get("journal")
        if snap is not None:
            # shift the worker's wall anchor BACK by its estimated offset
            # so its events land on the coordinator's timeline
            events += to_chrome(snap, pid=idx + 1,
                                process_name=f"worker-{idx}",
                                offset_us=-off_ms * 1000.0)
            dropped += snap.get("dropped", 0)
        for row in dump.get("latency") or []:
            latency.append({**row, "worker": idx})
    events.sort(key=lambda e: (e.get("ts", 0), e.get("pid", 0)))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"workers": len(worker_dumps),
                          "clock_offsets_ms": offsets,
                          "dropped_spans": dropped,
                          "latency": latency}}

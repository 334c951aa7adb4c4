"""Heartbeat manager: liveness monitoring between coordinators.

Analog of ``runtime/heartbeat/HeartbeatManagerImpl.java:43``: a *sender* side
periodically requests heartbeats from monitored targets; each target's last
response is timestamped; a target silent past the timeout triggers the
listener's ``notify_heartbeat_timeout`` — the failure-detection signal that
drives failover (SURVEY §5.3).

The port's copy of ``flink_tpu/cluster/heartbeat.py`` (host Python, as JAX's).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from flink_tpu_torch.testing import chaos


class HeartbeatTarget:
    """What the monitor pings (``HeartbeatTarget`` analog): any callable that
    requests a heartbeat from the remote side; the remote side answers by
    calling ``receive_heartbeat``."""

    def __init__(self, request_fn: Callable[[], None]):
        self.request_fn = request_fn


class HeartbeatMonitor:
    __slots__ = ("target", "last_heartbeat")

    def __init__(self, target: HeartbeatTarget, now: float):
        self.target = target
        self.last_heartbeat = now


def _monotonic() -> float:
    """Default liveness clock: the injectable seam (a chaos ``ClockSkew``
    on ``clock.monotonic`` can falsely age heartbeats — the
    local-clock-jump false suspect, distinct from the dropped-delivery
    partition)."""
    from flink_tpu_torch.utils.clock import monotonic
    return monotonic()


class HeartbeatManager:
    def __init__(self, interval_s: float = 0.2, timeout_s: float = 1.0,
                 on_timeout: Optional[Callable[[str], None]] = None,
                 clock: Callable[[], float] = _monotonic):
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self._clock = clock
        self._monitors: Dict[str, HeartbeatMonitor] = {}
        self._lock = threading.Lock()
        self._timer: Optional[threading.Timer] = None
        self._stopped = False

    def start(self) -> None:
        self._schedule()

    def monitor_target(self, resource_id: str, target: HeartbeatTarget) -> None:
        with self._lock:
            self._monitors[resource_id] = HeartbeatMonitor(target, self._clock())

    def unmonitor_target(self, resource_id: str) -> None:
        with self._lock:
            self._monitors.pop(resource_id, None)

    def receive_heartbeat(self, resource_id: str) -> None:
        # fault point: a partitioned target's heartbeats are dropped on the
        # floor (the monitor never sees them -> timeout fires even though
        # the target is alive — the classic one-way partition false
        # suspect).  direction="response" pairs with the request-side
        # firing in _tick: a Partition(direction=...) drops exactly one
        # of the two (the ASYMMETRIC partition); an undirected Partition
        # drops both.
        if not chaos.fire("heartbeat.deliver", target=resource_id,
                          direction="response"):
            return
        with self._lock:
            m = self._monitors.get(resource_id)
            if m is not None:
                m.last_heartbeat = self._clock()

    def _schedule(self) -> None:
        if self._stopped:
            return
        self._timer = threading.Timer(self.interval_s, self._tick)
        self._timer.daemon = True
        self._timer.start()

    def _tick(self) -> None:
        now = self._clock()
        with self._lock:
            items = list(self._monitors.items())
        dead = []
        for rid, m in items:
            if now - m.last_heartbeat > self.timeout_s:
                dead.append(rid)
            else:
                # fault point, request direction: the monitor's heartbeat
                # REQUEST can be partitioned away independently of the
                # target's response (direction="request")
                if not chaos.fire("heartbeat.deliver", target=rid,
                                  direction="request"):
                    continue
                try:
                    m.target.request_fn()
                except Exception:  # target unreachable → let timeout fire
                    pass
        for rid in dead:
            self.unmonitor_target(rid)
            if self.on_timeout is not None:
                self.on_timeout(rid)
        self._schedule()

    def stop(self) -> None:
        self._stopped = True
        if self._timer is not None:
            self._timer.cancel()

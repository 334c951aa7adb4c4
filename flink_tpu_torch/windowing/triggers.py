"""Triggers: when a window's contents are emitted (port of
``flink_tpu/windowing/triggers.py``; this slice carries the event-time
trigger only)."""

from __future__ import annotations


class Trigger:
    """Batched trigger contract: ``fires_on_time`` windows fire when time
    passes their end; ``fires_on_count`` triggers fire per micro-batch."""

    fires_on_time: bool = True
    fires_on_count: bool = False


class EventTimeTrigger(Trigger):
    """Default for event-time windows (``EventTimeTrigger.java``): FIRE when
    the watermark passes the window end; late elements within allowed
    lateness re-FIRE immediately."""

    fires_on_time = True

    @staticmethod
    def create() -> "EventTimeTrigger":
        return EventTimeTrigger()

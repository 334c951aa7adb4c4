"""Triggers: when a window's contents are emitted (port of
``flink_tpu/windowing/triggers.py``).

The batched runtime consults a trigger per micro-batch, not per record:
after each batch the operator asks which (key, window) cells a count
trigger fires (from the device counts), and on each watermark which
windows fire by time.  A count trigger therefore fires at batch boundaries,
as the reference's mini-batch operators do."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TriggerResult:
    fire: bool
    purge: bool

    CONTINUE = None  # filled below
    FIRE = None
    PURGE = None
    FIRE_AND_PURGE = None


TriggerResult.CONTINUE = TriggerResult(False, False)
TriggerResult.FIRE = TriggerResult(True, False)
TriggerResult.PURGE = TriggerResult(False, True)
TriggerResult.FIRE_AND_PURGE = TriggerResult(True, True)


class Trigger:
    """Batched trigger contract: ``fires_on_time`` windows fire when time
    passes their end; ``fires_on_count`` triggers fire per micro-batch when
    a (key, window) holds ``count_threshold`` more elements; a trigger that
    ``purges_on_fire`` clears (or, over sliding windows, retracts) what it
    fired."""

    fires_on_time: bool = True
    fires_on_count: bool = False
    count_threshold: int = 0
    purges_on_fire: bool = True

    def with_purging(self) -> "Trigger":
        return self


class EventTimeTrigger(Trigger):
    """Default for event-time windows (``EventTimeTrigger.java``): FIRE when
    the watermark passes the window end; late elements within allowed
    lateness re-FIRE immediately."""

    fires_on_time = True
    purges_on_fire = True

    @staticmethod
    def create() -> "EventTimeTrigger":
        return EventTimeTrigger()


class ProcessingTimeTrigger(Trigger):
    """FIRE when processing time passes the window end
    (``ProcessingTimeTrigger.java``)."""

    fires_on_time = True

    @staticmethod
    def create() -> "ProcessingTimeTrigger":
        return ProcessingTimeTrigger()


class CountTrigger(Trigger):
    """FIRE when a key's window holds >= n elements (``CountTrigger.java``),
    evaluated after each micro-batch against the device counts.

    ``purge=False`` (the reference's raw ``CountTrigger``): the window keeps
    accumulating and fires again every n elements with its whole running
    contents.  ``purge=True`` is ``countWindow``
    (``PurgingTrigger(CountTrigger)``): a fire clears the state, and the
    next fire needs n fresh elements.  Over sliding windows a purge needs
    an invertible aggregate (the window operator checks)."""

    fires_on_time = False
    fires_on_count = True

    def __init__(self, n: int, purge: bool = False):
        self.count_threshold = int(n)
        self.purges_on_fire = bool(purge)

    @staticmethod
    def of(n: int, purge: bool = False) -> "CountTrigger":
        return CountTrigger(n, purge)


class PurgingTrigger(Trigger):
    """Wraps a trigger so every FIRE becomes FIRE_AND_PURGE
    (``PurgingTrigger.java``)."""

    def __init__(self, inner: Trigger):
        self.inner = inner
        self.fires_on_time = inner.fires_on_time
        self.fires_on_count = inner.fires_on_count
        self.count_threshold = inner.count_threshold
        self.purges_on_fire = True

    @staticmethod
    def of(inner: Trigger) -> "PurgingTrigger":
        return PurgingTrigger(inner)


class NeverTrigger(Trigger):
    """The GlobalWindows default (``GlobalWindows.NeverTrigger``)."""

    fires_on_time = False
    fires_on_count = False

"""Injectable process clock — the single seam between the runtime and
wall/monotonic time (port of ``flink_tpu/utils/clock.py``).

Every time-dependent runtime component (processing-time ticks in the
executors and task drivers, state TTL in ``state/heap.py`` and
``state/spill.py``, session-gap closing, heartbeat liveness) reads time
through this module instead of calling ``time.time()`` directly, for two
reasons:

1. **Chaos**: an installed :class:`~flink_tpu_torch.testing.chaos.ClockSkew`
   schedule (points ``clock.wall`` / ``clock.monotonic``) offsets every
   reading deterministically — seeded backward steps, forward jumps and
   drift, the NTP-misbehaviour nemesis.  Consumers must therefore never
   assume two consecutive readings are ordered; components that need
   monotone time clamp at their own boundary (the executors' processing
   -time tick, ``InternalTimerService.advance_processing_time``).
2. **Tests**: a :class:`Clock` instance is injectable wherever a component
   takes a ``clock=`` parameter, without monkeypatching ``time``.

The chaos hook costs one module attribute read + ``None`` check when no
injector is installed (``chaos.skew``), so the hot paths can afford it.
"""

from __future__ import annotations

import time

from flink_tpu_torch.testing import chaos

__all__ = ["Clock", "SYSTEM_CLOCK", "now_ms", "now_ms_f", "monotonic",
           "MonotoneElapsed", "sleep"]


class Clock:
    """Wall + monotonic clock pair, chaos-overridable per reading."""

    def now_ms(self) -> int:
        """Wall clock in epoch milliseconds (``clock.wall`` skew point)."""
        return int(time.time() * 1000.0 + chaos.skew("clock.wall"))

    def now_ms_f(self) -> float:
        """Wall clock in epoch milliseconds WITHOUT the int truncation,
        same ``clock.wall`` skew point.  Latency tracking needs sub-ms
        resolution (hops routinely complete in <1 ms — quantized
        endpoints would record every such sample as 0), but must still
        sit behind the chaos seam like every other wall reading."""
        return time.time() * 1000.0 + chaos.skew("clock.wall")

    def monotonic(self) -> float:
        """Monotonic seconds (``clock.monotonic`` skew point, offset in
        ms).  NOTE: under an active skew schedule this is no longer
        monotone — that is the point of the nemesis."""
        return time.monotonic() + chaos.skew("clock.monotonic") / 1000.0


class MonotoneElapsed:
    """Elapsed-seconds tracker that stays MONOTONE under a skewed
    monotonic clock (chaos ``ClockSkew`` on ``clock.monotonic``).

    Checkpoint expiry and alignment timers measure *elapsed* time; under a
    backward clock step a naive ``now - start`` shrinks, which would
    un-expire an already-expired checkpoint (or push an alignment timeout
    into the future forever while the nemesis oscillates).  Readings here
    clamp at their own high-water mark, so expiry decisions never regress:
    once a deadline is passed it stays passed, matching the reference's
    monotone ``ProcessingTimeService`` contract for its checkpoint
    timeouts."""

    def __init__(self, clock: "Clock" = None):
        self._clock = clock if clock is not None else SYSTEM_CLOCK
        self._start = self._clock.monotonic()
        self._hw = 0.0

    def seconds(self) -> float:
        self._hw = max(self._hw, self._clock.monotonic() - self._start)
        return self._hw

    def ms(self) -> float:
        return self.seconds() * 1000.0


SYSTEM_CLOCK = Clock()


def now_ms() -> int:
    return SYSTEM_CLOCK.now_ms()


def now_ms_f() -> float:
    return SYSTEM_CLOCK.now_ms_f()


def monotonic() -> float:
    return SYSTEM_CLOCK.monotonic()


def sleep(seconds: float) -> None:
    """Pacing sleep — a raw ``time.sleep`` passthrough for poll-loop
    cadence.  Deliberately NOT skewed: chaos targets time *decisions*
    (deadlines, cooldowns, expiry — all of which must read
    :class:`MonotoneElapsed` / the skewed readings above), not the OS
    scheduler.  Living here keeps seam consumers off ``import time``
    entirely, so a stray ``time.time()`` decision can't sneak back in."""
    time.sleep(seconds)

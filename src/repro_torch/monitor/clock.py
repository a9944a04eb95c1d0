"""The monitor's time seam: one object that answers "what time is it"
and "wait this long".

Every piece of timing logic in the monitor stack — producer retry
backoff, heartbeat staleness, detection intervals, socket reconnect
backoff — reads time and sleeps through a :class:`Clock`, never through
``time`` directly.  Production uses :class:`SystemClock` (monotonic
time, real sleeps); tests use :class:`ManualClock`, where ``sleep``
*advances* virtual time instantly, so backoff schedules and staleness
windows are asserted exactly instead of calibrated against real
``time.sleep`` — timing tests cannot flake on a loaded CI box.

:func:`as_clock` adapts the historical ``clock=callable, sleep=callable``
pair (still accepted everywhere) into a Clock, so both styles keep
working.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Union


class Clock:
    """Monotonic time + sleep, as one injectable seam."""

    def monotonic(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    # clocks are callable so they slot into the legacy ``clock=`` knob
    def __call__(self) -> float:
        return self.monotonic()


class SystemClock(Clock):
    """Real time: ``time.monotonic`` + ``time.sleep``."""

    def monotonic(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class ManualClock(Clock):
    """Virtual time for deterministic tests.

    Starts at ``start``; ``sleep(d)`` advances time by ``d`` instantly
    (and records it in ``slept``, so backoff schedules are asserted
    exactly); ``advance(d)`` moves time without recording a sleep
    (the "wall clock passed" side of staleness tests).  Thread-safe:
    socket tests advance it from the main thread while IO threads read.
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._lock = threading.Lock()
        self.slept: list = []

    def monotonic(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float) -> None:
        with self._lock:
            self.slept.append(seconds)
            self._now += max(float(seconds), 0.0)

    def advance(self, seconds: float) -> None:
        with self._lock:
            self._now += float(seconds)


class _CallableClock(Clock):
    """Adapter for the legacy (clock-callable, sleep-callable) pair."""

    def __init__(self, monotonic_fn: Callable[[], float],
                 sleep_fn: Optional[Callable[[float], None]]):
        self._monotonic = monotonic_fn
        self._sleep = sleep_fn if sleep_fn is not None else time.sleep

    def monotonic(self) -> float:
        return self._monotonic()

    def sleep(self, seconds: float) -> None:
        self._sleep(seconds)


def as_clock(clock: Union[Clock, Callable[[], float], None],
             sleep: Optional[Callable[[float], None]] = None) -> Clock:
    """Normalize the injectable-time knobs into one :class:`Clock`.

    ``clock`` may be a Clock (returned as-is; a separate ``sleep``
    override still wins), a bare time callable (paired with ``sleep``,
    defaulting to ``time.sleep``), or None (system clock, or a system
    clock with the given ``sleep``)."""
    if isinstance(clock, Clock):
        if sleep is None:
            return clock
        return _CallableClock(clock.monotonic, sleep)
    if clock is None:
        if sleep is None:
            return SystemClock()
        return _CallableClock(time.monotonic, sleep)
    return _CallableClock(clock, sleep)

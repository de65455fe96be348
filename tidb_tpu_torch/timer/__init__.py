# ported from tidb_tpu/timer/__init__.py @ 9be2bf6
"""Generic timer framework driving background workers.

Reference analog: pkg/timer (9.5k LoC: timer store + runtime firing
hooks, used by TTL among others) — a single scheduler thread fires
registered timers at their interval; each timer records last-fire state
and errors; `trigger()` fires one synchronously (the test hook, like
the reference's manual timer store updates).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class Timer:
    name: str
    interval: float
    fn: Callable[[], object]
    enabled: bool = True
    last_fire: float = 0.0
    fire_count: int = 0
    last_error: str = ""


class TimerFramework:
    def __init__(self, tick: float = 0.5):
        self._timers: dict[str, Timer] = {}
        self._mu = threading.Lock()
        self._tick = tick
        self._closed = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register(self, name: str, interval: float,
                 fn: Callable[[], object]) -> Timer:
        t = Timer(name, interval, fn)
        with self._mu:
            self._timers[name] = t
        return t

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="timer-fw", daemon=True)
            self._thread.start()

    def close(self):
        """Stop the loop and wait for its thread (bounded: a timer that
        is firing finishes its run first)."""
        self._closed.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=30.0)

    def trigger(self, name: str):
        """Fire one timer synchronously (test/manual hook)."""
        with self._mu:
            t = self._timers[name]
        self._fire(t)

    def timers(self) -> list[Timer]:
        with self._mu:
            return list(self._timers.values())

    # ---------------------------------------------------------- #

    def _loop(self):
        while not self._closed.wait(self._tick):
            now = time.time()
            with self._mu:
                due = [t for t in self._timers.values()
                       if t.enabled and now - t.last_fire >= t.interval]
            for t in due:
                self._fire(t)

    def _fire(self, t: Timer):
        t.last_fire = time.time()
        t.fire_count += 1
        try:
            t.fn()
            t.last_error = ""
        except Exception as e:   # background workers never kill the loop
            t.last_error = f"{type(e).__name__}: {e}"


__all__ = ["TimerFramework", "Timer"]

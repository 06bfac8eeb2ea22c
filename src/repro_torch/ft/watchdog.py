"""Step watchdog: detects a hung step and fires a recovery callback (torch
port of ``repro/ft/watchdog.py``).

On real clusters a hung collective (dead peer) blocks forever; the watchdog
converts that into a bounded failure the trainer handles via
checkpoint-restore + elastic re-mesh. Also used per-attempt by
``ft.retry.RetryPolicy`` to turn a hung remote into a deadline failure.

Disarm contract: once ``disarm()`` (or ``arm()``, which re-arms) returns,
the previous timer can no longer set ``fired`` or invoke ``on_timeout`` —
a timer thread racing the disarm is fenced by a generation token checked
under the same lock the disarm holds. A fire that *wins* the race (the
timeout genuinely elapsed before the step completed) still runs; that is a
real timeout, not a race.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional


class Watchdog:
    def __init__(self, timeout_seconds: float,
                 on_timeout: Callable[[], None]):
        self.timeout = timeout_seconds
        self.on_timeout = on_timeout
        self._timer: Optional[threading.Timer] = None
        self._lock = threading.Lock()
        self._gen = 0               # bumped by every arm/disarm: a pending
        self.fired = False          # fire with a stale token is a no-op

    def arm(self) -> None:
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
            self._gen += 1
            gen = self._gen
            self.fired = False

            def fire():
                # Timer.cancel() cannot stop a function already running;
                # the token check (under the arm/disarm lock) is what
                # makes a concurrent disarm win deterministically.
                with self._lock:
                    if self._gen != gen:
                        return      # disarmed/re-armed first: stand down
                    self.fired = True
                self.on_timeout()   # outside the lock: callback may re-arm

            self._timer = threading.Timer(self.timeout, fire)
            self._timer.daemon = True
            self._timer.start()

    def disarm(self) -> None:
        with self._lock:
            self._gen += 1          # fence any in-flight fire
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None

    def __enter__(self):
        self.arm()
        return self

    def __exit__(self, *exc):
        self.disarm()

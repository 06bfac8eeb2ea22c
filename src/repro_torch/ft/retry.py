"""Self-healing retries: bounded attempts, exponential backoff + jitter,
per-operation deadlines (torch port of ``repro/ft/retry.py``; the schedule
is the reference's, attempt for attempt).

Why bounded *automatic* retry is correct here (and not a data hazard): every
replication state in this repo is reconstructible from content addresses —
blobs verify against their own hash, descriptors against their content
checksum, images against the config lock, and the manifest rename is the
only commit point. A failed attempt leaves orphans the next attempt
re-verifies (adopting intact bytes, deleting torn ones), so retrying to
convergence can never produce a torn replica; it can only finish the
remainder of the transfer. ``RetryPolicy`` is the control knob:

* ``max_attempts`` — total tries including the first; exhausting them
  QUARANTINES the operation (structured ``RetryHealth`` record, never an
  infinite loop on a persistently-sick destination).
* backoff — exponential (``base_delay_s * multiplier**n``) capped at
  ``max_delay_s``; the *pre-jitter* schedule is monotone non-decreasing by
  construction. Jitter adds a deterministic, seed-derived fraction in
  ``[0, jitter)`` on top — same seed, same schedule, every run.
* ``deadline_s`` — a per-operation wall budget: no backoff sleep is ever
  started that the deadline could not contain, and attempts stop once it
  is spent. Each attempt may additionally be watched by the existing
  ``ft.Watchdog`` (``attempt_timeout_s``): a call that returns only after
  its watchdog fired is counted as a deadline failure, so a hung remote
  turns into a bounded, observable failure instead of a forever-block.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

from .watchdog import Watchdog


@dataclass
class RetryHealth:
    """What an operation's retry loop actually did — the structured health
    record quarantine decisions and telemetry read."""

    attempts: int = 0               # calls made (first try included)
    retries: int = 0                # attempts beyond the first
    succeeded: bool = False
    quarantined: bool = False       # exhausted max_attempts (or deadline)
    deadline_exceeded: bool = False
    backoff_total_s: float = 0.0    # wall time spent sleeping
    wall_s: float = 0.0
    errors: List[str] = field(default_factory=list)

    def record_error(self, exc: BaseException) -> None:
        self.errors.append(f"{type(exc).__name__}: {exc}")


class RetryExhausted(RuntimeError):
    """Raised by ``RetryPolicy.run`` when every attempt failed; carries the
    health record and chains the last underlying error."""

    def __init__(self, msg: str, health: RetryHealth):
        super().__init__(msg)
        self.health = health


def _unit(seed: int, n: int) -> float:
    """Deterministic uniform [0,1) for attempt ``n`` — hash-derived, so the
    jitter schedule is a pure function of (seed, n)."""
    h = hashlib.sha256(f"backoff:{seed}:{n}".encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


@dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.1             # additive fraction in [0, jitter)
    deadline_s: Optional[float] = None
    attempt_timeout_s: Optional[float] = None   # per-attempt Watchdog
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.multiplier < 1.0 or self.base_delay_s < 0 or \
                self.jitter < 0:
            raise ValueError("multiplier >= 1, delays/jitter >= 0 required")

    # ---------------------------------------------------------- schedule
    def schedule(self, n: int) -> float:
        """Pre-jitter delay before retry ``n`` (0-based): exponential,
        capped — monotone non-decreasing in ``n`` by construction."""
        return min(self.base_delay_s * self.multiplier ** n,
                   self.max_delay_s)

    def backoff(self, n: int) -> float:
        """The actual delay before retry ``n``: schedule + deterministic
        seed-derived jitter (same seed => bit-identical schedule)."""
        return self.schedule(n) * (1.0 + self.jitter * _unit(self.seed, n))

    # --------------------------------------------------------------- run
    def execute(self, fn: Callable[[int], Any], *,
                sleep: Callable[[float], None] = time.sleep,
                clock: Callable[[], float] = time.monotonic,
                on_retry: Optional[Callable[[int, BaseException], None]]
                = None) -> Tuple[Optional[Any], RetryHealth]:
        """Run ``fn(attempt)`` (1-based) until it returns, attempts are
        exhausted, or the deadline is spent. Never raises for ``fn``
        failures — returns ``(result_or_None, health)`` so fan-out callers
        can quarantine without unwinding. ``CrashInjected``-style errors
        retry like any other: the next attempt IS the restarted process.
        """
        health = RetryHealth()
        t0 = clock()
        wd = Watchdog(self.attempt_timeout_s, lambda: None) \
            if self.attempt_timeout_s else None
        for attempt in range(1, self.max_attempts + 1):
            health.attempts = attempt
            health.retries = attempt - 1
            try:
                if wd is not None:
                    with wd:
                        result = fn(attempt)
                    if wd.fired:
                        raise TimeoutError(
                            f"attempt {attempt} exceeded "
                            f"{self.attempt_timeout_s}s watchdog")
                else:
                    result = fn(attempt)
                health.succeeded = True
                health.wall_s = clock() - t0
                return result, health
            except Exception as e:       # noqa: BLE001 — every failure
                health.record_error(e)   # class is retryable by design
                if on_retry is not None and attempt < self.max_attempts:
                    on_retry(attempt, e)
            if attempt >= self.max_attempts:
                break
            delay = self.backoff(attempt - 1)
            if self.deadline_s is not None:
                elapsed = clock() - t0
                if elapsed + delay > self.deadline_s:
                    # never start a sleep the deadline cannot contain
                    health.deadline_exceeded = True
                    break
            sleep(delay)
            health.backoff_total_s += delay
        health.quarantined = True
        health.wall_s = clock() - t0
        return None, health

    def run(self, fn: Callable[[int], Any], **kw) -> Any:
        """The raising form of ``execute`` — for single-destination callers
        (``CheckpointFollower``) where exhaustion is an error."""
        result, health = self.execute(fn, **kw)
        if not health.succeeded:
            raise RetryExhausted(
                f"exhausted {health.attempts} attempts "
                f"(deadline_exceeded={health.deadline_exceeded}); last "
                f"error: {health.errors[-1] if health.errors else 'n/a'}",
                health)
        return result

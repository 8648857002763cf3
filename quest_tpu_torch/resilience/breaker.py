"""Per-program circuit breaker driving the serving degradation ladder.

A port of quest_tpu/resilience/breaker.py. When one circuit's primary
program keeps failing to build, retrying it on every batch taxes every
other program's latency. So each failure domain — a queue's program key
— gets a breaker: after `QUEST_SERVE_BREAKER_THRESHOLD` consecutive
primary failures it OPENS and the serving engine stops trying the fused
program, stepping that program's requests down the ladder (fused ->
banded -> host) so they keep completing. After `cooldown_s` the breaker
lets one probe through (HALF_OPEN); a healthy probe CLOSES it and fused
service resumes, a failing one re-opens it for another cooldown.

State machine:

    CLOSED --record_failure x threshold--> OPEN
    OPEN --cooldown elapsed (next allow_primary)--> HALF_OPEN (probe)
    HALF_OPEN --record_success--> CLOSED
    HALF_OPEN --record_failure--> OPEN (cooldown restarts)

Single owner: the serving worker thread is the only caller (the dispatch
watchdog touches a breaker only while that worker is provably stuck), so
there is no internal locking. Standard library only.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class Breaker:
    """One failure domain's breaker (the engine keys them by
    program_key). `on_transition(old, new)` fires on every state change
    — the engine hangs its metrics (breaker_opens/closes counters, the
    breakers-open gauge) off it."""

    def __init__(self, threshold: int, cooldown_s: float = 0.5,
                 on_transition: Optional[Callable[[str, str], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.state = CLOSED
        self.failures = 0           # consecutive primary failures
        self.opened_at: Optional[float] = None
        self._on_transition = on_transition
        self._clock = clock

    def _transition(self, new: str) -> None:
        old, self.state = self.state, new
        if old != new and self._on_transition is not None:
            self._on_transition(old, new)

    def allow_primary(self) -> bool:
        """Whether THIS dispatch may try the primary (fused) engine.
        CLOSED: yes. OPEN: only once the cooldown has elapsed — that
        call IS the half-open probe (the single-owner worker resolves
        it via record_success/record_failure before asking again)."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self._clock() - self.opened_at >= self.cooldown_s:
                self._transition(HALF_OPEN)
                return True
            return False
        return True                 # HALF_OPEN: the probe in progress

    def record_success(self) -> None:
        self.failures = 0
        if self.state != CLOSED:
            self._transition(CLOSED)

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == HALF_OPEN or (self.state == CLOSED
                                       and self.failures >= self.threshold):
            self.opened_at = self._clock()
            self._transition(OPEN)

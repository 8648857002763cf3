"""Worker supervision policy: bounded restarts with backoff and jitter.

A port of quest_tpu/resilience/supervisor.py. The serving engine owns
one worker thread; a crash escaping its loop would strand every queued
future. `Supervisor` is the policy half of the remedy: per crash it
decides whether the worker restarts (and after how long) or the engine
gives up and turns FAILED. The mechanism half — requeueing undispatched
requests, failing dispatched ones, resolving every future on give-up —
lives in the engine (`ServeEngine._worker_main`).

Restart k sleeps `base * 2^(k-1)` capped at `cap`, plus a seeded
uniform jitter slice, so a crash-looping worker neither spins hot nor
restarts in lockstep with anything else. Standard library only.
"""

from __future__ import annotations

import random
from typing import Optional


class Supervisor:
    """Restart budget + backoff schedule for one supervised worker.

    `next_backoff()` is called once per crash: it returns the seconds to
    sleep before the restart, or None when the budget
    (`QUEST_SERVE_RESTART_MAX`) is exhausted and the owner must fail
    loudly instead of restarting. `record_success()` (called after a
    healthy stretch, e.g. a completed dispatch) refills the budget —
    restarts are a CRASH-LOOP bound, not a lifetime quota."""

    def __init__(self, max_restarts: int, base_s: float = 0.05,
                 cap_s: float = 2.0, jitter_frac: float = 0.25,
                 seed: int = 0):
        if max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0, got {max_restarts}")
        self.max_restarts = int(max_restarts)
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.jitter_frac = float(jitter_frac)
        self.restarts = 0           # consecutive crashes since success
        self.total_restarts = 0
        self._rng = random.Random(seed)

    def next_backoff(self) -> Optional[float]:
        """Seconds to sleep before the next restart, or None when the
        consecutive-crash budget is exhausted."""
        if self.restarts >= self.max_restarts:
            return None
        self.restarts += 1
        self.total_restarts += 1
        delay = min(self.cap_s, self.base_s * (2 ** (self.restarts - 1)))
        if delay <= 0.0:
            return 0.0
        return delay + self._rng.uniform(0.0, self.jitter_frac * delay)

    @property
    def remaining(self) -> int:
        """Restarts left in the consecutive-crash budget right now —
        the per-replica health figure ServeFleet.stats() surfaces so an
        operator can see which replica is one crash from FAILED."""
        return max(0, self.max_restarts - self.restarts)

    def record_success(self) -> None:
        """A healthy work cycle completed: reset the consecutive-crash
        count so one crash per hour never exhausts a budget meant to
        stop crash LOOPS."""
        self.restarts = 0

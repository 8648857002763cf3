"""Elastic autoscaling for the serving fleet: pressure in, replicas out.

A port of quest_tpu/serve/autoscaler.py. A ServeFleet grows with
`add_replica()` (a process replica's boot is an interpreter, a CUDA
context and library loads, never a kernel build) and shrinks with
`remove_replica()` (the emptiest replica drains behind a tombstone, so
no in-flight ticket dangles). This module decides when:

  * SIGNALS — each `tick()` reads the fleet's own instruments:
    `stats()["pressure"]` (the number the shed path keys on) and the
    delta of the `shed_requests` counter since the previous tick. A tick
    is one pure function of (signals, streaks) -> "up" / "down" / None,
    so tests drive the loop without threads or sleeps.
  * HYSTERESIS — one hot tick never scales. Pressure at or above
    `high_water` (or any shedding) for `up_ticks` consecutive ticks
    grows the fleet; at or below `low_water` with no shedding for
    `down_ticks` consecutive ticks shrinks it; a tick in the neutral
    band resets both streaks. Growing is eager (shed traffic is lost
    work), shrinking lazy (a respawn costs a worker boot), so
    `down_ticks` defaults higher than `up_ticks`.
  * COOLDOWN — after a scaling action the loop holds for
    `cooldown_ticks` ticks, so the pre-scale backlog does not trigger a
    second spawn for the same burst.
  * BOUNDS — the live replica count stays inside
    [QUEST_FLEET_MIN_REPLICAS, QUEST_FLEET_MAX_REPLICAS] whatever the
    signals say; remove_replica's refusal to drop the last live replica
    backs it.

`tick()` is the unit of behaviour; `start()` / `stop()` run it on a
daemon thread every `interval_s`. Scaling shows in the fleet's counters
fleet_scale_ups / fleet_scale_downs and in this module's gauges
autoscaler_pressure, autoscaler_up_streak and autoscaler_down_streak.
The module imports only the standard library (and the knob registry,
when the bounds are left to the knobs).
"""

from __future__ import annotations

import threading
from typing import Optional


class Autoscaler:
    """The control loop over one ServeFleet (or anything with its
    `registry`, `stats()`, `add_replica()` and `remove_replica()`).

    `tick()` may be called from tests and from the `start()` thread;
    `_lock` serializes whole ticks, so streak state never interleaves.
    The fleet calls inside a tick take no Autoscaler state with them."""

    _GUARDED_BY = {
        "_lock": ("_up_streak", "_down_streak", "_cooldown",
                  "_last_shed", "_ticks", "_actions"),
        # the metronome thread handle belongs to the caller driving
        # start() / stop()
        "<owner-thread>": ("_thread",),
    }

    def __init__(self, fleet, *,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 high_water: float = 0.75,
                 low_water: float = 0.15,
                 up_ticks: int = 2,
                 down_ticks: int = 5,
                 cooldown_ticks: int = 3,
                 interval_s: float = 1.0) -> None:
        if min_replicas is None or max_replicas is None:
            from quest_tpu_torch.env import knob_value
            if min_replicas is None:
                min_replicas = knob_value("QUEST_FLEET_MIN_REPLICAS")
            if max_replicas is None:
                max_replicas = knob_value("QUEST_FLEET_MAX_REPLICAS")
        min_replicas = int(min_replicas)
        max_replicas = int(max_replicas)
        if min_replicas > max_replicas:
            raise ValueError(
                f"Invalid operation: QUEST_FLEET_MIN_REPLICAS="
                f"{min_replicas} > QUEST_FLEET_MAX_REPLICAS={max_replicas}"
                f" — the autoscaler's bounds must form a non-empty range.")
        if not (0.0 <= low_water < high_water):
            raise ValueError(
                f"Invalid operation: need 0 <= low_water < high_water, got "
                f"low_water={low_water}, high_water={high_water} — an "
                f"inverted band would scale up and down on the same tick.")
        self.fleet = fleet
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.high_water = float(high_water)
        self.low_water = float(low_water)
        self.up_ticks = max(1, int(up_ticks))
        self.down_ticks = max(1, int(down_ticks))
        self.cooldown_ticks = max(0, int(cooldown_ticks))
        self.interval_s = float(interval_s)
        self._lock = threading.Lock()
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown = 0
        self._last_shed = self._shed_total()
        self._ticks = 0
        self._actions: list = []    # (tick, "up" | "down") audit trail
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _shed_total(self) -> int:
        snap = self.fleet.registry.snapshot()
        return int(snap["counters"].get("shed_requests", 0))

    # -- the decision ------------------------------------------------------

    def tick(self) -> Optional[str]:
        """One control-loop step: read the signals, update the streaks,
        maybe scale. Returns "up" / "down" when a scaling action happened
        this tick, else None."""
        with self._lock:
            return self._tick_locked()

    def _tick_locked(self) -> Optional[str]:
        self._ticks += 1
        stats = self.fleet.stats()
        pressure = float(stats["pressure"])
        live = [r for r in stats["replicas"] if not r["retired"]]
        shed_now = self._shed_total()
        shed_delta = shed_now - self._last_shed
        self._last_shed = shed_now

        reg = self.fleet.registry
        reg.gauge("autoscaler_pressure").set(pressure)
        hot = pressure >= self.high_water or shed_delta > 0
        cold = pressure <= self.low_water and shed_delta == 0
        self._up_streak = self._up_streak + 1 if hot else 0
        self._down_streak = self._down_streak + 1 if cold else 0
        reg.gauge("autoscaler_up_streak").set(self._up_streak)
        reg.gauge("autoscaler_down_streak").set(self._down_streak)

        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        n = len(live)
        if self._up_streak >= self.up_ticks and n < self.max_replicas:
            self.fleet.add_replica()
            self._after_action("up")
            return "up"
        if self._down_streak >= self.down_ticks and n > self.min_replicas:
            # a short drain: the victim is the emptiest replica. An
            # overdue drain rolls back in the fleet (no accepted work is
            # lost) and this tick records no action, so the streak
            # re-arms a later attempt
            try:
                self.fleet.remove_replica(timeout_s=self.interval_s)
            except TimeoutError:
                return None
            self._after_action("down")
            return "down"
        return None

    def _after_action(self, kind: str) -> None:
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown = self.cooldown_ticks
        self._actions.append((self._ticks, kind))

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        """The loop's state: ticks, streaks, cooldown, the actions taken,
        its bounds and its band."""
        with self._lock:
            return {
                "ticks": self._ticks,
                "up_streak": self._up_streak,
                "down_streak": self._down_streak,
                "cooldown": self._cooldown,
                "actions": list(self._actions),
                "bounds": (self.min_replicas, self.max_replicas),
                "band": (self.low_water, self.high_water),
            }

    # -- the metronome -----------------------------------------------------

    def start(self) -> "Autoscaler":
        """Run `tick()` every `interval_s` on a daemon thread until
        `stop()`. Idempotent; returns self."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception:
                    # a fleet mid-close or all-FAILED must not kill the
                    # metronome; the next tick reads the state again
                    continue

        self._thread = threading.Thread(
            target=loop, name="quest-autoscaler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(1.0, 2 * self.interval_s))
            self._thread = None

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

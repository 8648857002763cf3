"""Metrics: counters, gauges and latency histograms, standard library only.

The registry half of quest_tpu/serve/metrics.py:57-258, the part the
durable executor records into (resilience/durable.py): counters
`durable_steps_run`, `durable_checkpoints_saved`, `durable_resumes`,
`durable_corrupt_checkpoints_skipped`, `durable_sentinel_trips`,
`durable_elastic_resumes`; gauge `durable_last_checkpoint_step`;
histogram `durable_checkpoint_s` (the per-cut sentinel, copy and write
cost). The Prometheus scrape, its parser and the /metrics server wait
for the serving runtime (ROADMAP A12).

`snapshot()` returns one JSON-serializable dict:

    {"counters": {name: int, ...},
     "gauges": {name: float, ...},
     "histograms": {name: {"count": int, "mean": float,
                           "p50": float, "p95": float, "p99": float},
                    ...}}

Histograms keep a bounded reservoir (the most recent `RESERVOIR`
observations) plus exact count and sum: percentiles are over the recent
window, count and mean over the process lifetime.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

RESERVOIR = 4096   # recent observations kept per histogram


class Counter:
    """A monotonically increasing integer metric (thread-safe)."""

    __slots__ = ("name", "_value", "_lock")
    _GUARDED_BY = {"_lock": ("_value",)}

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """A settable point-in-time value (thread-safe): current breaker
    count, queue depth — anything that goes DOWN as well as up."""

    __slots__ = ("name", "_value", "_lock")
    _GUARDED_BY = {"_lock": ("_value",)}

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Observation stream with recent-window percentiles (thread-safe).

    count/sum are exact over the process lifetime; p50/p95/p99 are over
    the last `RESERVOIR` observations (sorted on demand at snapshot
    time, never on the record path)."""

    __slots__ = ("name", "_recent", "_count", "_sum", "_lock")
    _GUARDED_BY = {"_lock": ("_recent", "_count", "_sum")}

    def __init__(self, name: str):
        self.name = name
        self._recent: deque = deque(maxlen=RESERVOIR)
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, x: float) -> None:
        x = float(x)
        with self._lock:
            self._recent.append(x)
            self._count += 1
            self._sum += x

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        """Exact lifetime sum of observations (like `count`): delta
        reads over (count, sum) let a caller derive time-in-phase
        without touching slot internals (the durable executor's
        checkpoint cost, `durable_checkpoint_s`, reads this way)."""
        return self._sum

    def summary(self) -> Dict[str, float]:
        with self._lock:
            data = sorted(self._recent)
            count, total = self._count, self._sum
        if not data:
            return {"count": count, "mean": 0.0,
                    "p50": 0.0, "p95": 0.0, "p99": 0.0}

        def pct(q: float) -> float:
            return data[min(len(data) - 1,
                            max(0, int(round(q * (len(data) - 1)))))]

        return {"count": count, "mean": total / max(count, 1),
                "p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99)}


class Registry:
    """A named set of counters and histograms. Metric creation is
    get-or-create by name, so call sites never coordinate; `snapshot()`
    is the one read API (stable schema, JSON-serializable)."""

    _GUARDED_BY = {"_lock": ("_counters", "_gauges", "_histograms")}

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name)
            return h

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {n: c.value for n, c in sorted(counters.items())},
            "gauges": {n: g.value for n, g in sorted(gauges.items())},
            "histograms": {n: h.summary()
                           for n, h in sorted(histograms.items())},
        }


# the process-wide default registry: the durable executor records here
# unless given its own
REGISTRY = Registry()


def snapshot(registry: Optional[Registry] = None) -> dict:
    """Snapshot of `registry` (default: the process-wide REGISTRY)."""
    return (registry or REGISTRY).snapshot()

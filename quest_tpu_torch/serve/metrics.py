"""Metrics: counters, gauges and latency histograms, standard library only.

A port of quest_tpu/serve/metrics.py. The serving engine
(serve/engine.py) records its serve_* series here, and the durable
executor (resilience/durable.py) its counters `durable_steps_run`,
`durable_checkpoints_saved`, `durable_resumes`,
`durable_corrupt_checkpoints_skipped`, `durable_sentinel_trips`,
`durable_elastic_resumes`, gauge `durable_last_checkpoint_step` and
histogram `durable_checkpoint_s` (the per-cut sentinel, copy and write
cost).

`Registry.scrape()` renders the metrics as Prometheus text exposition
(histograms as summaries), `parse_scrape` reads that text back into the
snapshot schema, `render_snapshot` renders a snapshot dict the same
way, `merge_snapshots` folds several snapshots into one, and
`serve_scrape` serves a registry at /metrics (`python -m
quest_tpu_torch.serve.metrics --port 9464`).

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
        # quest-lint: disable=QL005(single int attr load is atomic under the GIL)
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
        # quest-lint: disable=QL005(single float attr load is atomic under the GIL)
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
        # quest-lint: disable=QL005(single int attr load is atomic under the GIL)
        return self._count

    @property
    def sum(self) -> float:
        """Exact lifetime sum of observations (like `count`): delta
        reads over (count, sum) let a caller derive time-in-phase
        without touching slot internals (the durable executor's
        checkpoint cost, `durable_checkpoint_s`, reads this way)."""
        # quest-lint: disable=QL005(single float attr load is atomic under the GIL)
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


    def scrape(self) -> str:
        """Prometheus text exposition (format 0.0.4) of every metric:
        counters and gauges as themselves, histograms as summaries
        (quantiles over the recent window, exact lifetime _sum and
        _count). parse_scrape reads it back into the snapshot schema."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        lines = []
        for n, c in sorted(counters.items()):
            n = _prom_name(n)
            lines += [f"# TYPE {n} counter", f"{n} {c.value}"]
        for n, g in sorted(gauges.items()):
            n = _prom_name(n)
            lines += [f"# TYPE {n} gauge", f"{n} {_prom_value(g.value)}"]
        for n, h in sorted(histograms.items()):
            s = h.summary()
            n = _prom_name(n)
            lines.append(f"# TYPE {n} summary")
            for q, key in (("0.5", "p50"), ("0.95", "p95"),
                           ("0.99", "p99")):
                lines.append(f'{n}{{quantile="{q}"}} {_prom_value(s[key])}')
            lines += [f"{n}_sum {_prom_value(h.sum)}",
                      f"{n}_count {h.count}"]
        return "\n".join(lines) + "\n"


# the process-wide default registry: the serving engine and the durable
# executor record here unless given their own
REGISTRY = Registry()


def snapshot(registry: Optional[Registry] = None) -> dict:
    """Snapshot of `registry` (default: the process-wide REGISTRY)."""
    return (registry or REGISTRY).snapshot()


# ---------------------------------------------------------------------------
# Prometheus text format: name/value rendering + the scrape parser
# ---------------------------------------------------------------------------


def _prom_name(name: str) -> str:
    """A valid Prometheus metric name: [a-zA-Z_:][a-zA-Z0-9_:]*. Our
    metric names already conform; tenant-derived names sanitize any
    other byte to '_' so a hostile tenant label cannot corrupt the
    exposition."""
    out = "".join(ch if (ch.isascii() and (ch.isalnum() or ch in "_:"))
                  else "_" for ch in name)
    if not out or not (out[0].isalpha() or out[0] in "_:"):
        out = "_" + out
    return out


def _prom_value(v: float) -> str:
    """repr keeps full float precision; integers render bare (the
    format accepts both, and bare ints keep counter lines exact)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def parse_scrape(text: str) -> dict:
    """Parse Prometheus text-format exposition (as produced by
    `Registry.scrape()`) back into the `snapshot()` schema —
    a dashboard dump and a live /metrics response read identically.
    Summaries map back to histograms (mean derived from _sum/_count);
    unknown or untyped series parse as gauges. Raises ValueError on a
    line that is neither a comment nor `name[{labels}] value`."""
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    summaries: Dict[str, dict] = {}
    types: Dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        # name[{labels}] value [timestamp]
        if "{" in line:
            name, rest = line.split("{", 1)
            labels, rest = rest.split("}", 1)
        else:
            name, _, rest = line.partition(" ")
            labels = ""
        fields = rest.split()
        if not name or not fields:
            raise ValueError(
                f"scrape line {lineno} is not Prometheus text format: "
                f"{line!r}")
        try:
            value = float(fields[0])
        except ValueError:
            raise ValueError(
                f"scrape line {lineno} has a non-numeric value: "
                f"{line!r}")
        name = name.strip()
        base = name
        for suffix in ("_sum", "_count"):
            if name.endswith(suffix) and types.get(name[:-len(suffix)]) \
                    in ("summary", "histogram"):
                base = name[:-len(suffix)]
        kind = types.get(base, types.get(name))
        if kind in ("summary", "histogram"):
            h = summaries.setdefault(
                base, {"count": 0, "mean": 0.0, "p50": 0.0,
                       "p95": 0.0, "p99": 0.0, "_sum": 0.0})
            if name.endswith("_sum"):
                h["_sum"] = value
            elif name.endswith("_count"):
                h["count"] = int(value)
            else:
                q = dict(part.split("=", 1) for part in labels.split(",")
                         if "=" in part).get("quantile", "").strip('"')
                key = {"0.5": "p50", "0.95": "p95", "0.99": "p99"}.get(q)
                if key:
                    h[key] = value
        elif kind == "counter":
            counters[name] = int(value)
        else:
            gauges[name] = value
    histograms = {}
    for name, h in summaries.items():
        total = h.pop("_sum")
        h["mean"] = total / h["count"] if h["count"] else 0.0
        histograms[name] = h
    return {"counters": counters, "gauges": gauges,
            "histograms": histograms}


# ---------------------------------------------------------------------------
# multi-registry aggregation
# ---------------------------------------------------------------------------


def merge_snapshots(snaps) -> dict:
    """Fold several `snapshot()` dicts into one (several engines' or
    processes' registries as one exposition). Counters and gauges SUM
    across them (pending and occupancy gauges are additive; a gauge one
    writer owns appears in one snapshot only, so the sum is the
    identity). Histogram summaries
    merge as: exact summed `count`, count-weighted `mean`, and the
    WORST replica's quantiles — an upper bound, which is the
    conservative direction for latency alerting (exact cross-process
    quantiles would need the raw reservoirs on the wire every beat)."""
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, dict] = {}
    for snap in snaps:
        if not snap:
            continue
        for n, v in snap.get("counters", {}).items():
            counters[n] = counters.get(n, 0) + v
        for n, v in snap.get("gauges", {}).items():
            gauges[n] = gauges.get(n, 0.0) + v
        for n, s in snap.get("histograms", {}).items():
            cur = hists.get(n)
            if cur is None:
                hists[n] = dict(s)
                continue
            total = cur["count"] + s["count"]
            if total:
                cur["mean"] = (cur["mean"] * cur["count"]
                               + s["mean"] * s["count"]) / total
            cur["count"] = total
            for q in ("p50", "p95", "p99"):
                cur[q] = max(cur[q], s[q])
    return {"counters": dict(sorted(counters.items())),
            "gauges": dict(sorted(gauges.items())),
            "histograms": dict(sorted(hists.items()))}


def render_snapshot(snap: dict) -> str:
    """Prometheus text exposition of a `snapshot()`-schema dict — the
    same format `Registry.scrape()` emits, so `parse_scrape`
    round-trips it. Histogram
    `_sum` derives from mean*count (snapshots carry mean, not sum)."""
    lines = []
    for n, v in snap.get("counters", {}).items():
        n = _prom_name(n)
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n} {_prom_value(v)}")
    for n, v in snap.get("gauges", {}).items():
        n = _prom_name(n)
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {_prom_value(v)}")
    for n, s in snap.get("histograms", {}).items():
        n = _prom_name(n)
        lines.append(f"# TYPE {n} summary")
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            lines.append(f'{n}{{quantile="{q}"}} '
                         f"{_prom_value(s.get(key, 0.0))}")
        total = s.get("mean", 0.0) * s.get("count", 0)
        lines.append(f"{n}_sum {_prom_value(total)}")
        lines.append(f"{n}_count {int(s.get('count', 0))}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# the scrape endpoint: python -m quest_tpu_torch.serve.metrics --port 9464
# ---------------------------------------------------------------------------


def serve_scrape(registry: Optional[Registry] = None,
                 host: str = "127.0.0.1", port: int = 0):
    """An HTTP server exposing `registry` (default: the process-wide
    REGISTRY) at /metrics in Prometheus text format. `registry` may be
    anything with a `.scrape() -> str`. Returns the
    ThreadingHTTPServer — callers run `serve_forever()` (the __main__
    below does) or drive it from a daemon thread and `shutdown()` when
    done (tests scrape a real GET this way). port=0 binds an ephemeral
    port, readable from `server.server_address`."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    reg = registry if registry is not None else REGISTRY

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):                      # noqa: N802 - http.server API
            if self.path.split("?")[0] not in ("/", "/metrics"):
                self.send_error(404, "only /metrics is served")
                return
            body = reg.scrape().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):          # quiet: scrapes are periodic
            pass

    return ThreadingHTTPServer((host, port), _Handler)


def _main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m quest_tpu_torch.serve.metrics",
        description="Serve the process-wide metrics registry at /metrics "
                    "in Prometheus text format.")
    ap.add_argument("--port", type=int, required=True,
                    help="TCP port to listen on (0 = ephemeral)")
    ap.add_argument("--host", default="127.0.0.1")
    args = ap.parse_args(argv)
    srv = serve_scrape(REGISTRY, host=args.host, port=args.port)
    host, port = srv.server_address[:2]
    print(f"serving /metrics on http://{host}:{port}/metrics "
          f"(Ctrl-C to stop)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    import sys
    raise SystemExit(_main(sys.argv[1:]))

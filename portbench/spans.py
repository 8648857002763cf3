"""The port's own spans as the traced run's readers see them
(quest_tpu_torch.profiling.annotate): the records the program kept while
the profiler ran, those inside the traced window, the idle gaps of the
device trace attributed to the innermost program span open on the job's
thread, and the program's always-on span totals. Records and the trace
share one clock (time.time_ns). A program without spans gives None, and
its readers then report nothing."""

from __future__ import annotations

import bisect
import threading
from collections import defaultdict

NO_SPAN = "no program span"


def _profiling():
    try:
        from quest_tpu_torch import profiling
    except ImportError:
        return None
    return profiling


def records(rec, names=None):
    """The span records inside the traced window of `rec` (of the given
    names, all without), or None where the program keeps none."""
    profiling = _profiling()
    if rec.trace is None or not hasattr(profiling, "spans"):
        return None
    lo, hi = rec.trace.lo, rec.trace.hi
    return [s for s in profiling.spans()
            if lo <= s["t0_ns"] and s["t1_ns"] <= hi
            and (names is None or s["name"] in names)]


def totals():
    """The program's span totals ({name: {"calls", "seconds"}}), or None
    where it keeps none."""
    profiling = _profiling()
    if not hasattr(profiling, "span_totals"):
        return None
    return profiling.span_totals()


def mean_device_ms(rec, name: str):
    """Mean device time of the window's spans called `name`; None
    without one."""
    ms = [s["device_ms"] for s in records(rec, {name}) or ()
          if s["device_ms"] is not None]
    return sum(ms) / len(ms) if ms else None


def innermost(spans):
    """[(start, end, name)]: the stretches in which each span is the
    innermost open one, of spans nested as one thread opens them."""
    out, stack, t = [], [], 0
    for s in sorted(spans, key=lambda s: (s["t0_ns"], -s["t1_ns"])):
        while stack and stack[-1]["t1_ns"] <= s["t0_ns"]:
            top = stack.pop()
            if top["t1_ns"] > t:
                out.append((t, top["t1_ns"], top["name"]))
            t = max(t, top["t1_ns"])
        if stack and s["t0_ns"] > t:
            out.append((t, s["t0_ns"], stack[-1]["name"]))
        t = max(t, s["t0_ns"])
        stack.append(s)
    while stack:
        top = stack.pop()
        if top["t1_ns"] > t:
            out.append((t, top["t1_ns"], top["name"]))
        t = max(t, top["t1_ns"])
    return out


def idle_by_span(rec, thread: int = None):
    """{span name: [idle seconds, gaps]}: each gap of the device trace
    in the window, by its midpoint, under the innermost program span
    open on `thread` (the main thread, where the harness runs its jobs)
    then, or NO_SPAN; None where the program keeps no span records."""
    spans = records(rec)
    if spans is None:
        return None
    thread = threading.main_thread().ident if thread is None else thread
    stretches = innermost([s for s in spans if s["thread"] == thread])
    starts = [lo for lo, _, _ in stretches]
    out = defaultdict(lambda: [0.0, 0])
    for lo, hi in rec.trace.gaps():
        mid = (lo + hi) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = (stretches[i][2] if i >= 0 and mid < stretches[i][1]
                else NO_SPAN)
        out[name][0] += (hi - lo) * 1e-9
        out[name][1] += 1
    return dict(out)

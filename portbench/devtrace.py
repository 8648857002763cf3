"""The traced run's reading of a torch.profiler trace of the device
activity alone (kernels, copies, memsets: no host op is recorded, so the
profiler adds little to the host's work): the operations inside the
traced window, their union (busy time), and the breakdown the result
line carries. The window and the job's phases are host timestamps
(time.time_ns), the clock the profiler's timestamps are on."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
NOT_OPS = ("Stream Sync", "Event Sync", "Context Sync", "Device Sync",
           "Stream Wait Event")
NAME_CHARS = 120


def _kind(ev) -> str:
    """kernel, gpu_memcpy or gpu_memset; anything else (annotations,
    synchronisation records) is not a device operation."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return str(kind())
    name = ev.name()
    if getattr(ev, "is_user_annotation", lambda: False)() or \
            name.startswith(NOT_OPS) or name.startswith("portbench."):
        return "other"
    return ("gpu_memcpy" if name.startswith("Memcpy")
            else "gpu_memset" if name.startswith("Memset") else "kernel")


def _union(spans):
    """Sorted disjoint (start, end) intervals covering `spans`."""
    out = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


class Phases:
    """The job's phases on the host clock, while a trace runs: `phase(name)`
    is the context manager a job wraps each phase in."""

    def __init__(self):
        self.spans = []

    @contextlib.contextmanager
    def phase(self, name: str):
        lo = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((lo, time.time_ns(), name))


class Trace:
    """The device operations of a profile that overlap the window (lo, hi)
    (ns), with the phases of the jobs run in it."""

    def __init__(self, prof, lo: int, hi: int, phases):
        from torch.autograd import DeviceType
        self.lo, self.hi, self.phases = lo, hi, sorted(phases)
        self.ops = []
        for ev in prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            start = ev.start_ns()
            end = start + ev.duration_ns()
            if end > lo and start < hi and _kind(ev) in DEVICE_KINDS:
                self.ops.append((ev.name(), start, end, _kind(ev)))
        self.ops.sort(key=lambda o: o[1])

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-9

    def busy_s(self) -> float:
        busy = _union((max(lo, self.lo), min(hi, self.hi))
                      for _, lo, hi, _ in self.ops)
        return sum(hi - lo for lo, hi in busy) * 1e-9

    def device_s(self) -> float:
        """Summed duration of the device operations in the window."""
        return sum(hi - lo for _, lo, hi, _ in self.ops) * 1e-9

    def kernels(self) -> int:
        return sum(1 for o in self.ops if o[3] == "kernel")

    def gaps(self):
        """(start, end) of every stretch of the window with no device
        operation running."""
        out, t = [], self.lo
        for lo, hi in _union((lo, hi) for _, lo, hi, _ in self.ops):
            if lo > t:
                out.append((t, min(lo, self.hi)))
            t = max(t, hi)
        if t < self.hi:
            out.append((t, self.hi))
        return [(lo, hi) for lo, hi in out if hi > lo]

    def _phase_at(self, points):
        """For each sorted point, the phase whose span holds it."""
        out, i = [], 0
        for p in points:
            while i < len(self.phases) and self.phases[i][1] < p:
                i += 1
            hit = i < len(self.phases) and self.phases[i][0] <= p
            out.append(self.phases[i][2] if hit else "between jobs")
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, summed by name, and
        the idle gaps summed by what the host was doing in them (the
        job's phase, or between jobs)."""
        by_op = defaultdict(float)
        for name, lo, hi, _ in self.ops:
            by_op[name[:NAME_CHARS]] += (hi - lo) * 1e-9
        gaps = self.gaps()
        by_gap = defaultdict(lambda: [0.0, 0])
        for (lo, hi), phase in zip(gaps, self._phase_at(
                [(lo + hi) // 2 for lo, hi in gaps])):
            by_gap[phase][0] += (hi - lo) * 1e-9
            by_gap[phase][1] += 1
        ranked_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        ranked_gaps = sorted(by_gap.items(), key=lambda kv: -kv[1][0])[:top]
        return {"device_ops": [[k, v] for k, v in ranked_ops],
                "idle_gaps": [[f"host in {k}, {n} gaps", s]
                              for k, (s, n) in ranked_gaps]}

    def summary(self) -> str:
        """One line for the log: the window and where its operations lie."""
        if not self.ops:
            return "trace: no device operation in the window"
        return (f"trace: {len(self.ops)} device operations, window "
                f"{self.window_s:.3f} s, first at +"
                f"{(self.ops[0][1] - self.lo) * 1e-6:.3f} ms, last ends "
                f"{(self.hi - self.ops[-1][2]) * 1e-6:.3f} ms before its end")

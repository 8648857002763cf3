"""device_idle: the share of the traced window in which no device
operation ran, from the profiler's kernel, copy and memset intervals."""


def read(rec):
    if rec.trace is None or not rec.trace.ops:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s() / rec.trace.window_s)

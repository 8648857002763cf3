"""job_ms: the window's seconds x 1000 over the jobs it completed (host
clock; the window ends when the last job's readout reaches the host)."""


def read(rec):
    return rec.window_s * 1000.0 / rec.jobs if rec.jobs else None

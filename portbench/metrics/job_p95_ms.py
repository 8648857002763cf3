"""job_p95_ms: the 95th percentile of the window's job times, each job
timed by CUDA events on the stream around it (device timestamps: a job
is shorter than the 250 ms a host-clock span needs). Reported only where
at least ten jobs lie beyond it."""

import numpy as np

BEYOND = 10


def read(rec):
    if not rec.job_s:
        return None
    ms = np.asarray(rec.job_s) * 1000.0
    p95 = float(np.percentile(ms, 95))
    return p95 if int((ms > p95).sum()) >= BEYOND else None

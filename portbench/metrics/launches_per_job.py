"""launches_per_job: the kernels in the traced window over the jobs it
ran."""


def read(rec):
    if rec.trace is None or not rec.trace.ops or not rec.jobs:
        return None
    return rec.trace.kernels() / rec.jobs

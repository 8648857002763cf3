"""quench.launches_per_job: launches_per_job (metrics/launches_per_job.py) in the quench cell. The host
paces that cell (tens of thousands of small launches a job, a sync at each
energy), so its job time follows the host's speed and has a bound of its
own; its per-layer metrics move that bound's metric."""

from portbench import byname

read = byname.module("metrics", "launches_per_job").read

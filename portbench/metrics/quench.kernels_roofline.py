"""quench.kernels_roofline: kernels_roofline (metrics/kernels_roofline.py) in the quench cell. The host
paces that cell (tens of thousands of small launches a job, a sync at each
energy), so its job time follows the host's speed and has a bound of its
own; its per-layer metrics move that bound's metric."""

from portbench import byname

read = byname.module("metrics", "kernels_roofline").read

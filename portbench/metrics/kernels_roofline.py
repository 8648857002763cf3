"""kernels_roofline: the least time the traced jobs' work needs on the
card (portbench/counting.py: counted from the gate list or Hamiltonian,
the larger of its flops over the float32 peak and its bytes over the
memory bandwidth), as a share of the summed device time of every kernel,
copy and memset the traced window ran."""


def read(rec):
    if rec.trace is None or not rec.trace.ops:
        return None
    return 100.0 * rec.least_s * rec.jobs / rec.trace.device_s()

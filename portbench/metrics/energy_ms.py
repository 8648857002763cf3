"""energy_ms: CUDA events around one calc_expec_pauli_sum of the cell's
Hamiltonian on the last job's state, after the traced window (the median
of three); only quench jobs measure it."""


def read(rec):
    return rec.probes.get("energy_ms")

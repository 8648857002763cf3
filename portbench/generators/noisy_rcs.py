"""noisy_rcs: noisy_rcs_circuit(n, depth) of quest_tpu_torch. Per layer a
rotation on every qubit, a cz brick, depolarising(p) on every qubit and
damping(p) on one qubit; the kinds and the damped qubits drawn as that
builder draws them from `structure_seed` (a kind, then an angle, per
qubit), the angles from the run's seed."""

import numpy as np

from portbench.traffic import ROT, TWO_PI, stream


def generate(n: int, mix: dict, seed: int) -> list:
    kinds = np.random.default_rng(mix["structure_seed"])
    angles = stream(seed, "angles")
    gates = []
    for d in range(mix["depth"]):
        for q in range(n):
            kind = ROT[int(kinds.integers(0, 3))]
            kinds.uniform(0, TWO_PI)
            gates.append((kind, q, float(angles.uniform(0, TWO_PI))))
        gates += [("cz", q, q + 1) for q in range(d % 2, n - 1, 2)]
        gates += [("depolarising", q, mix["depolarising"]) for q in range(n)]
        gates.append(("damping", int(kinds.integers(0, n)), mix["damping"]))
    return gates

"""rcs: random_circuit(n, depth, entangler="cz") of quest_tpu_torch. Per
layer a rotation rx / ry / rz on every qubit, then a cz brick on
(d % 2, d % 2 + 1), ... The kinds are those that random_circuit draws
from `structure_seed` (its own stream: an angle, then a kind, per
qubit); the angles come from the run's seed."""

import numpy as np

from portbench.traffic import ROT, TWO_PI, stream


def generate(n: int, mix: dict, seed: int) -> list:
    kinds = np.random.default_rng(mix["structure_seed"])
    angles = stream(seed, "angles")
    gates = []
    for d in range(mix["depth"]):
        for q in range(n):
            kinds.uniform(0, TWO_PI)
            gates.append((ROT[int(kinds.integers(0, 3))], q,
                          float(angles.uniform(0, TWO_PI))))
        gates += [("cz", q, q + 1) for q in range(d % 2, n - 1, 2)]
    return gates

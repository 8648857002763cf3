"""The one traffic generator: a mix file's parameters and the run's seed
in, the frozen inputs of every job out. The mix names its generator,
`portbench/generators/<generator>.py`, found by name; a generator draws
the structure of the work (gate kinds, qubits) from the mix's fixed
`structure_seed` and only the values (angles, coefficients) from the
run's seed, so every seed runs the same work.

Gate lists are the tuples portbench.reference.circuits reads.
"""

from __future__ import annotations

import zlib

import numpy as np

from portbench import byname

ROT = ("rx", "ry", "rz")
TWO_PI = 2 * np.pi


def stream(seed: int, name: str) -> np.random.Generator:
    """An independent numpy stream of the run's seed for one purpose."""
    return np.random.default_rng([int(seed) % (1 << 64),
                                  zlib.crc32(name.encode())])


def generate(n: int, mix: dict, seed: int):
    """The inputs of a mix at width n for the run's seed."""
    return byname.module("generators", mix["generator"]).generate(n, mix, seed)

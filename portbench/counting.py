"""The work a job needs, counted from its gate list or Hamiltonian as
stated, never from the port's plan, so the count is the same whatever
implements it:

  * a dense gate or channel is its dense operator on the state bits it
    names: 8 flops (a complex multiply-add) per amplitude per column of
    the operator. A one-qubit rotation names one bit of a statevector
    (2 columns); on a density matrix it and a one-qubit channel name a
    row and a column bit (4 columns);
  * a diagonal gate (rz, cz, a ZZ exponential) is an elementwise complex
    product: 6 flops per amplitude;
  * the state is written once and read once per job, and every readout
    that reduces over the whole state (sampling's probabilities, purity,
    each energy evaluation) reads it once more; complex64 planes are 8
    bytes an amplitude.

The least time is the larger of the flops over the card's float32 peak
and the bytes over its memory bandwidth (peaks.json: the data sheet's
H100 SXM rates at its 700 W power limit); both are lower bounds, so a
kernel time under it means a miscount.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())

CMAC_FLOPS = 8
CMUL_FLOPS = 6
AMP_BYTES = 8
DENSE = ("rx", "ry", "depolarising", "damping")
DIAGONAL = ("rz", "cz")


def gate_flops(gate, amps: int, density: bool) -> float:
    kind = gate[0]
    if kind in DENSE:
        return CMAC_FLOPS * amps * (4 if density else 2)
    if kind in DIAGONAL:
        return CMUL_FLOPS * amps
    raise ValueError(f"no counting rule for {kind!r}")


def circuit_work(gates, nbits: int, density: bool, reads: int) -> dict:
    """Flops and bytes of one job that resets an nbits-bit state, applies
    `gates` and reduces over the state `reads` times."""
    amps = 1 << nbits
    return {"flops": float(sum(gate_flops(g, amps, density) for g in gates)),
            "bytes": float(AMP_BYTES * amps * (2 + reads))}


def quench_work(ham: dict, n: int, steps: int, energies: int) -> dict:
    """Flops and bytes of `steps` order-2 steps of a ZZ / X Hamiltonian
    (each ZZ term's exponential twice a step, each X term's once) with
    `energies` energy evaluations."""
    amps = 1 << n
    per_step = (2 * len(ham["couplings"]) * CMUL_FLOPS
                + len(ham["fields"]) * CMAC_FLOPS * 2) * amps
    return {"flops": float(steps * per_step),
            "bytes": float(AMP_BYTES * amps * (2 + energies))}


def least_seconds(work: dict) -> float:
    """The least time the work needs on the card."""
    return max(work["flops"] / PEAKS["fp32_flops_per_s"],
               work["bytes"] / PEAKS["hbm_bytes_per_s"])

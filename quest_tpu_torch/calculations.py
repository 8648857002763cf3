"""Scalar calculations on registers: total probability and purity.

Ports of quest_tpu/calculations.py:45 and :85, plain reductions (the
reference has them in XLA, outside Pallas). Like the reference they
accumulate in f64 (its stand-in for the reference QuEST's Kahan sums);
the f64 copy is taken a chunk at a time, so an 8 GiB f32 state never
needs a 16 GiB f64 twin.
"""

from __future__ import annotations

import torch

from quest_tpu_torch import validation as val

CHUNK_AMPS = 1 << 26


def _sum_sq(planes: torch.Tensor) -> float:
    """sum of squares of every element of `planes`, in f64."""
    flat = planes.reshape(-1)
    total = torch.zeros((), dtype=torch.float64, device=flat.device)
    for start in range(0, flat.numel(), CHUNK_AMPS):
        chunk = flat[start:start + CHUNK_AMPS].to(torch.float64)
        total += torch.dot(chunk, chunk)
    return float(total)


def calc_total_prob(q) -> float:
    """Total probability: sum |a|^2 of a statevector, Re Tr(rho) of a
    density matrix."""
    if q.is_density:
        dim = 1 << q.num_qubits
        diag = q.amps.reshape(2, -1)[0][::dim + 1]     # rho[r, r] at r (1 + dim)
        return float(diag.to(torch.float64).sum())
    return _sum_sq(q.amps)


def calc_purity(q) -> float:
    """Tr(rho^2) = sum |rho_ij|^2 (ref densmatr_calcPurityLocal)."""
    val.validate_density_matr(q)
    return _sum_sq(q.amps)

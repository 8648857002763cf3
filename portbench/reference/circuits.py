"""Gate lists, product formulas and readouts on the plain reference.

A gate list is a list of tuples, in the order they act:

    ("rx" | "ry" | "rz", q, angle)     exp(-i angle/2 P) on qubit q
    ("cz", a, b)                       the controlled Z
    ("depolarising", q, p)             the channel of QuEST's mixDepolarising
    ("damping", q, p)                  the channel of QuEST's mixDamping

The benchmark hands the same list to the port's Circuit methods.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.core import (CHUNK, Diagonal, Precision,
                                      apply_layer, density_diagonal)

ROTATIONS = ("rx", "ry", "rz")
CHANNELS = ("depolarising", "damping")

_I = np.eye(2, dtype=np.complex128)
_X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
_Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
_Z = np.array([[1, 0], [0, -1]], dtype=np.complex128)


def rotation(kind: str, angle: float) -> np.ndarray:
    """exp(-i angle/2 P), P = X, Y or Z."""
    p = {"rx": _X, "ry": _Y, "rz": _Z}[kind]
    return np.cos(angle / 2) * _I - 1j * np.sin(angle / 2) * p


def kraus(kind: str, p: float):
    """The Kraus operators of a one-qubit channel."""
    if kind == "depolarising":
        return [np.sqrt(1 - p) * _I] + [np.sqrt(p / 3) * m
                                        for m in (_X, _Y, _Z)]
    if kind == "damping":
        return [np.array([[1, 0], [0, np.sqrt(1 - p)]], dtype=np.complex128),
                np.array([[0, np.sqrt(p)], [0, 0]], dtype=np.complex128)]
    raise ValueError(f"unknown channel {kind!r}")


def zero_state(nbits: int, prec: Precision, device) -> torch.Tensor:
    psi = torch.zeros(1 << nbits, dtype=prec.complex, device=device)
    psi[0] = 1
    return psi


def _runs(gates):
    """The list cut into runs that act at once: one-qubit rotations on
    distinct qubits, cz gates (which commute), or a single channel."""
    run, kind = [], None
    for g in gates:
        k = ("rot" if g[0] in ROTATIONS else "cz" if g[0] == "cz"
             else "channel")
        fresh = (k != kind or k == "channel"
                 or (k == "rot" and any(h[1] == g[1] for h in run)))
        if fresh and run:
            yield kind, run
            run = []
        run.append(g)
        kind = k
    if run:
        yield kind, run


def _cz_terms(run):
    return [("and", g[1], g[2], np.pi) for g in run]


def apply_channel(rho: torch.Tensor, n: int, q: int, ops,
                  prec: Precision) -> torch.Tensor:
    """rho <- sum_k K rho K^dagger on qubit q, in place: the
    superoperator on (row bit q, column bit q + n)."""
    s4 = sum(np.einsum("ab,cd->acbd", k, k.conj()) for k in ops)
    s4 = torch.as_tensor(s4, dtype=prec.complex, device=rho.device)
    x = rho.view(1 << (n - 1 - q), 2, 1 << (n - 1), 2, 1 << q)
    parts = {(r, c): x[:, c, :, r, :].clone() for r in (0, 1) for c in (0, 1)}
    for r2 in (0, 1):
        for c2 in (0, 1):
            out = x[:, c2, :, r2, :]
            out.zero_()
            for (r, c), part in parts.items():
                out += s4[r2, c2, r, c] * part
    return rho


def run_statevector(psi: torch.Tensor, n: int, gates,
                    prec: Precision) -> torch.Tensor:
    """Apply a gate list without channels to an n-qubit state, in place."""
    for kind, run in _runs(gates):
        if kind == "rot":
            apply_layer(psi, n, {g[1]: rotation(g[0], g[2]) for g in run},
                        prec)
        elif kind == "cz":
            Diagonal(n, _cz_terms(run)).apply_phase(psi, prec)
        else:
            raise ValueError(f"a statevector takes no channel: {run[0]}")
    return psi


def run_density(rho: torch.Tensor, n: int, gates,
                prec: Precision) -> torch.Tensor:
    """Apply a gate list to an n-qubit density matrix, in place: U on the
    row bits and conj(U) on the column bits; channels as superoperators."""
    for kind, run in _runs(gates):
        if kind == "rot":
            mats = {g[1]: rotation(g[0], g[2]) for g in run}
            apply_layer(rho, 2 * n, mats, prec, width=n)
            apply_layer(rho, 2 * n, {q: m.conj() for q, m in mats.items()},
                        prec, offset=n, width=n)
        elif kind == "cz":
            density_diagonal(n, _cz_terms(run)).apply_phase(rho, prec)
        else:
            g = run[0]
            apply_channel(rho, n, g[1], kraus(g[0], g[2]), prec)
    return rho


# -- Pauli sums of ZZ couplings and X fields ----------------------------------


def zz_x_strang_step(psi: torch.Tensor, n: int, couplings, fields, dt: float,
                     prec: Precision) -> torch.Tensor:
    """One order-2 (Strang) step of H = sum J Z_a Z_b + sum h X_q, the
    diagonal block first: exp(-i dt/2 H_zz) exp(-i dt H_x)
    exp(-i dt/2 H_zz), each group exponentiated exactly."""
    half = Diagonal(n, [("zz", a, b, -0.5 * dt * j) for a, b, j in couplings])
    half.apply_phase(psi, prec)
    apply_layer(psi, n, {q: np.cos(dt * h) * _I - 1j * np.sin(dt * h) * _X
                         for q, h in fields}, prec)
    half.apply_phase(psi, prec)
    return psi


def x_expectation(psi: torch.Tensor, n: int, q: int) -> float:
    """<psi| X_q |psi> = 2 Re sum conj(psi_x) psi_(x + 2^q) over bit q = 0."""
    v = psi.view(1 << (n - 1 - q), 2, 1 << q)
    rows = max(1, CHUNK // (2 << q))
    cols = min(1 << q, CHUNK)
    total = torch.zeros((), dtype=torch.float64, device=psi.device)
    for r in range(0, v.shape[0], rows):
        for c in range(0, v.shape[2], cols):
            blk = v[r:r + rows, :, c:c + cols]
            total += (blk[:, 0].conj() * blk[:, 1]).real.to(torch.float64).sum()
    return 2.0 * float(total)


def zz_x_energy(psi: torch.Tensor, n: int, couplings, fields) -> float:
    """<psi| H |psi> of H = sum J Z_a Z_b + sum h X_q, in float64."""
    zz = Diagonal(n, [("zz", a, b, j) for a, b, j in couplings])
    return zz.expectation(psi) + sum(h * x_expectation(psi, n, q)
                                     for q, h in fields)


# -- readouts -----------------------------------------------------------------


def probabilities_cdf(psi: torch.Tensor) -> torch.Tensor:
    """The cumulative Born probabilities of a state, in float64."""
    out = torch.empty(psi.numel(), dtype=torch.float64, device=psi.device)
    carry = torch.zeros((), dtype=torch.float64, device=psi.device)
    for s in range(0, psi.numel(), CHUNK):
        c = torch.cumsum(psi[s:s + CHUNK].abs().to(torch.float64) ** 2, 0)
        out[s:s + CHUNK] = c + carry
        carry = out[min(s + CHUNK, psi.numel()) - 1]
    return out


def sample(cdf: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF samples of the uniforms: the first index whose
    cumulative probability exceeds u times the total."""
    t = uniforms.to(device=cdf.device, dtype=torch.float64) * cdf[-1]
    return torch.searchsorted(cdf, t, right=True).clamp_(max=cdf.numel() - 1)


def sample_gap(cdf: torch.Tensor, samples: torch.Tensor,
               uniforms: torch.Tensor) -> float:
    """The widest distance, as a share of the total probability, between
    a shot's scaled uniform and the cumulative interval of the index it
    was given: 0 for an exact inverse-CDF draw."""
    s = samples.to(device=cdf.device, dtype=torch.int64).reshape(-1)
    t = uniforms.to(device=cdf.device, dtype=torch.float64).reshape(-1) \
        * cdf[-1]
    upper = cdf[s]
    lower = torch.where(s > 0, cdf[(s - 1).clamp(min=0)],
                        torch.zeros_like(upper))
    gap = (lower - t).clamp(min=0) + (t - upper).clamp(min=0)
    return float(gap.max() / cdf[-1])


def linear_xeb(psi: torch.Tensor, samples: torch.Tensor) -> float:
    """2^n <p(s)> - 1 over the samples, in float64."""
    s = samples.to(device=psi.device, dtype=torch.int64).reshape(-1)
    p = psi[s].abs().to(torch.float64) ** 2
    return float(psi.numel() * p.mean() - 1.0)


def density_trace(rho: torch.Tensor, n: int) -> float:
    """Re Tr(rho)."""
    return float(rho[::(1 << n) + 1].real.to(torch.float64).sum())


def density_purity(rho: torch.Tensor) -> float:
    """Tr(rho^2) = sum |rho_ij|^2 of a Hermitian rho, in float64."""
    total = torch.zeros((), dtype=torch.float64, device=rho.device)
    for s in range(0, rho.numel(), CHUNK):
        total += (rho[s:s + CHUNK].abs().to(torch.float64) ** 2).sum()
    return float(total)

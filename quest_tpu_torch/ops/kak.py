"""KAK (Cartan) decomposition of two-qubit unitaries.

The port's copy of quest_tpu/ops/kak.py (jax-free there too), kept
so that quest_tpu_torch imports nothing of the JAX package; the
text below is the reference's.

Any U in U(4) factors as

    U = e^{i phi} (A1 x B1) . exp(i (x XX + y YY + z ZZ)) . (A2 x B2)

(the standard magic-basis construction; e.g. Vatan & Williams,
quant-ph/0308006). The framework uses it to keep CROSS-BAND two-qubit
unitaries fused: the local factors are single-qubit gates (band-composable
anywhere), and each interaction exponential becomes a PARITY rotation in a
local basis —

    exp(i t XX) = (H x H)   exp(i t ZZ) (H x H)
    exp(i t YY) = (V x V)   exp(i t ZZ) (V x V)^dagger,  V = S H
    exp(i t ZZ) = the engine's parity phase (multiRotateZ semantics),

and parity phases fuse on ANY pair of qubits (they read only the index
parity — the insight the reference uses to skip communication,
QuEST_cpu.c:3069-3109). So a general 2q gate across bands costs ~13
fusable ops instead of a multi-pass XLA fallback. This replaces the
reference's swap-to-local relabeling for multi-target gates
(QuEST_cpu_distributed.c:1441-1483) with pure gate algebra.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_MAGIC = np.array([[1, 0, 0, 1j],
                   [0, 1j, 1, 0],
                   [0, 1j, -1, 0],
                   [1, 0, 0, -1j]], dtype=np.complex128) / np.sqrt(2)

_H = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2)
_S = np.diag([1.0, 1.0j]).astype(np.complex128)
_V = _S @ _H                       # X = H Z H ; Y = V Z V^dagger


def _kron_factor(m4: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Factor a (numerically) rank-1 Kronecker product m4 = A (x) B."""
    t = m4.reshape(2, 2, 2, 2).transpose(0, 2, 1, 3).reshape(4, 4)
    u, s, vh = np.linalg.svd(t)
    a = (u[:, 0] * np.sqrt(s[0])).reshape(2, 2)
    b = (vh[0, :] * np.sqrt(s[0])).reshape(2, 2)
    # balance the scalar so both factors are unitary (up to joint phase)
    da = np.sqrt(np.abs(np.linalg.det(a)))
    if da > 1e-12:
        a, b = a / da, b * da
    return a, b


def _orthogonal_diagonalize(p: np.ndarray) -> np.ndarray:
    """Real orthogonal O with O^T p O diagonal, for a complex symmetric
    unitary p (its commuting real/imag parts share an eigenbasis)."""
    pr, pi = p.real, p.imag
    rng = np.random.default_rng(7)
    for _ in range(16):
        t = rng.standard_normal()
        _, o = np.linalg.eigh(pr + t * pi)
        d = o.T @ p @ o
        if np.max(np.abs(d - np.diag(np.diag(d)))) < 1e-9:
            return o
    raise ValueError("failed to jointly diagonalize magic-basis product")


def kak_decompose(u: np.ndarray):
    """Decompose a 4x4 unitary (matrix bit 0 = first target) into
    (a1, b1, (x, y, z), a2, b2, phase) with
    u = phase * (b1 (x) a1) @ CAN(x,y,z) @ (b2 (x) a2),
    CAN = exp(i (x XX + y YY + z ZZ)) — Kronecker order matches the
    little-endian matrix convention (kron(B, A) acts with A on bit 0)."""
    u = np.asarray(u, dtype=np.complex128)
    m = _MAGIC.conj().T @ u @ _MAGIC
    p = m.T @ m
    o2 = _orthogonal_diagonalize(p)
    if np.linalg.det(o2) < 0:
        o2[:, 0] = -o2[:, 0]
    d = np.diag(o2.T @ p @ o2)
    dsq = np.exp(1j * np.angle(d) / 2.0)      # principal branch of sqrt(d)
    # fix the branch product so det factors come out +1:
    # prod(dsq)^2 = det(p) = det(m)^2, so prod(dsq) = +-det(m)
    detm = np.linalg.det(m)
    if np.abs(np.prod(dsq) - detm) > np.abs(np.prod(dsq) + detm):
        dsq = dsq.copy()
        dsq[0] = -dsq[0]
    o1 = m @ o2 @ np.diag(1.0 / dsq)
    if np.max(np.abs(o1.imag)) > 1e-7:
        raise ValueError("kak: left factor not real")
    o1 = o1.real
    # det(o1) = det(m)/prod(dsq) * det(o2) = +1 by the fixes above
    # interaction angles: angle(dsq) = g*1 + x*cx + y*cy + z*cz with the
    # generator diagonals cx/cy/cz computed once from the magic basis
    hp = np.angle(dsq)
    g, x, y, z = np.linalg.solve(_GEN_COEFF, hp)
    k1 = _MAGIC @ o1 @ _MAGIC.conj().T
    k2 = _MAGIC @ o2.T @ _MAGIC.conj().T
    b1, a1 = _kron_factor(k1)
    b2, a2 = _kron_factor(k2)
    phase = np.exp(1j * g)
    # absorb any residual scalar (kron-factor phase conventions) by
    # comparing against the input once
    recon = phase * np.kron(b1, a1) @ _canonical(x, y, z) @ np.kron(b2, a2)
    scale = u[np.unravel_index(np.argmax(np.abs(u)), u.shape)] / \
        recon[np.unravel_index(np.argmax(np.abs(u)), u.shape)]
    phase = phase * scale
    return a1, b1, (x, y, z), a2, b2, phase


_X2 = np.array([[0, 1], [1, 0]], dtype=np.complex128)
_Y2 = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
_Z2 = np.diag([1.0, -1.0]).astype(np.complex128)


def _canonical(x, y, z):
    from scipy.linalg import expm
    gen = (x * np.kron(_X2, _X2) + y * np.kron(_Y2, _Y2)
           + z * np.kron(_Z2, _Z2))
    return expm(1j * gen)


def _gen_diag(pauli):
    g = np.kron(pauli, pauli)
    d = _MAGIC.conj().T @ g @ _MAGIC
    assert np.max(np.abs(d - np.diag(np.diag(d)))) < 1e-12
    return np.real(np.diag(d))


_GEN_COEFF = np.stack([np.ones(4), _gen_diag(_X2), _gen_diag(_Y2),
                       _gen_diag(_Z2)], axis=1)


def kak_gate_sequence(u: np.ndarray, qa: int, qb: int) -> List[Tuple]:
    """Gate sequence implementing the 2q unitary `u` on qubits (qa, qb)
    (qa = matrix bit 0), in application order. Items:
      ("1q", qubit, 2x2 matrix) | ("parity", (qa, qb), angle)
    where "parity" uses the engine's exp(-i angle/2 Z x Z) convention."""
    a1, b1, (x, y, z), a2, b2, phase = kak_decompose(u)
    seq: List[Tuple] = []
    seq.append(("1q", qa, a2))
    seq.append(("1q", qb, b2))
    # exp(i x XX)
    if abs(x) > 1e-12:
        seq.append(("1q", qa, _H))
        seq.append(("1q", qb, _H))
        seq.append(("parity", (qa, qb), -2.0 * x))
        seq.append(("1q", qa, _H))
        seq.append(("1q", qb, _H))
    # exp(i y YY)
    if abs(y) > 1e-12:
        vdg = _V.conj().T
        seq.append(("1q", qa, vdg))
        seq.append(("1q", qb, vdg))
        seq.append(("parity", (qa, qb), -2.0 * y))
        seq.append(("1q", qa, _V))
        seq.append(("1q", qb, _V))
    # exp(i z ZZ)
    if abs(z) > 1e-12:
        seq.append(("parity", (qa, qb), -2.0 * z))
    # locals + global phase (folded into the qa factor)
    seq.append(("1q", qa, phase * a1))
    seq.append(("1q", qb, b1))
    return seq

"""Gate-matrix constructors — host-side numpy.

The port's copy of quest_tpu/ops/matrices.py (jax-free there too), kept
so that quest_tpu_torch imports nothing of the JAX package; the
text below is the reference's.

All functions here produce concrete numpy complex matrices on the host;
they are packed into (re, im) float pairs at the jit boundary (see
quest_tpu.cplx — complex data never crosses host<->device directly).
Parameterized gates that must stay dynamic under jit are built inside the
trace by the builders in quest_tpu.ops.gates instead.

Conventions follow the reference exactly:
  - compactUnitary(alpha, beta) = [[alpha, -conj(beta)], [beta, conj(alpha)]]
    (ref QuEST_cpu.c:1656-1713 butterfly)
  - rotateAroundAxis(theta, n) = cos(t/2) I - i sin(t/2) (n . sigma)
    (ref getComplexPairFromRotation, QuEST_common.c:114-122)
  - phaseShift(theta) = diag(1, e^{i theta}); S = diag(1, i);
    T = diag(1, e^{i pi/4}) (ref QuEST_common.c:250-290)
  - sqrtSwap per ref QuEST_common.c:383-407
  - Kraus superoperator Sum_k conj(K) (x) K with the conj factor on the
    high (column-space) matrix bits (ref macro_populateKrausOperator,
    QuEST_common.c:540-600)
"""

from __future__ import annotations

import numpy as np

_SQRT2_INV = 1.0 / np.sqrt(2.0)

PAULI_I = np.eye(2, dtype=np.complex128)
PAULI_X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
PAULI_Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
PAULI_Z = np.array([[1, 0], [0, -1]], dtype=np.complex128)
PAULIS = (PAULI_I, PAULI_X, PAULI_Y, PAULI_Z)

HADAMARD = np.array([[1, 1], [1, -1]], dtype=np.complex128) * _SQRT2_INV

# SWAP exchanges |01> and |10> (matrix bit 0 = first target)
SWAP = np.array(
    [[1, 0, 0, 0],
     [0, 0, 1, 0],
     [0, 1, 0, 0],
     [0, 0, 0, 1]], dtype=np.complex128)

SQRT_SWAP = np.array(
    [[1, 0, 0, 0],
     [0, 0.5 + 0.5j, 0.5 - 0.5j, 0],
     [0, 0.5 - 0.5j, 0.5 + 0.5j, 0],
     [0, 0, 0, 1]], dtype=np.complex128)

S_DIAG = np.array([1, 1j], dtype=np.complex128)
T_DIAG = np.array([1, _SQRT2_INV * (1 + 1j)], dtype=np.complex128)
Z_DIAG = np.array([1, -1], dtype=np.complex128)


def compact_unitary(alpha, beta) -> np.ndarray:
    alpha, beta = complex(alpha), complex(beta)
    return np.array([[alpha, -np.conj(beta)], [beta, np.conj(alpha)]])


def rotation_pair(angle, axis):
    """(alpha, beta) for rotateAroundAxis; axis normalized on the fly."""
    ax = np.asarray(axis, dtype=np.float64)
    ax = ax / np.linalg.norm(ax)
    half = float(angle) / 2.0
    c, s = np.cos(half), np.sin(half)
    return complex(c, -s * ax[2]), complex(s * ax[1], -s * ax[0])


def rotation(angle, axis) -> np.ndarray:
    alpha, beta = rotation_pair(angle, axis)
    return compact_unitary(alpha, beta)


def phase_diag(angle) -> np.ndarray:
    """diag(1, e^{i angle})."""
    return np.array([1.0, np.exp(1j * float(angle))])


def damping_kraus(p: float):
    """Amplitude-damping Kraus pair {K0=diag(1,sqrt(1-p)), K1=sqrt(p)|0><1|}
    (ref mixDamping operators, QuEST_cpu.c:130-180). The ONE place these
    live — shared by the density channels, circuit builders, and the
    trajectory unraveling."""
    return [np.array([[1.0, 0.0], [0.0, np.sqrt(1.0 - p)]]),
            np.array([[0.0, np.sqrt(p)], [0.0, 0.0]])]


def dephasing_kraus(p: float):
    """Phase-damping pair {sqrt(1-p) I, sqrt(p) Z} (ref mixDephasing)."""
    return [np.sqrt(1.0 - p) * PAULI_I, np.sqrt(p) * PAULI_Z]


def depolarising_kraus(p: float):
    """Depolarising quadruple (ref mixDepolarising)."""
    return [np.sqrt(1.0 - p) * PAULI_I, np.sqrt(p / 3.0) * PAULI_X,
            np.sqrt(p / 3.0) * PAULI_Y, np.sqrt(p / 3.0) * PAULI_Z]


def pauli_kraus(px: float, py: float, pz: float):
    """Probabilistic-Pauli quadruple (ref densmatr_mixPauli,
    QuEST_common.c:675-695)."""
    return [np.sqrt(1.0 - px - py - pz) * PAULI_I, np.sqrt(px) * PAULI_X,
            np.sqrt(py) * PAULI_Y, np.sqrt(pz) * PAULI_Z]


def kraus_superoperator(ops) -> np.ndarray:
    """Sum_k conj(K_k) (x) K_k, a 2k-qubit operator on the doubled register.

    Row/col index layout: low k bits act on the row-space copy of the targets
    (the K factor), high k bits on the column-space copy (the conj(K) factor)
    — matching the reference's allTargets = [targs..., targs+N...] ordering
    (QuEST_common.c:601-640).
    """
    ops = [np.asarray(op, dtype=np.complex128) for op in ops]
    dim = ops[0].shape[0]
    sup = np.zeros((dim * dim, dim * dim), dtype=np.complex128)
    for op in ops:
        sup += np.kron(np.conj(op), op)
    return sup


def controlled_embed(matrix: np.ndarray, num_controls: int) -> np.ndarray:
    """Embed a k-qubit matrix as a (k+c)-qubit matrix controlled on the HIGH
    c bits being all-1. Used by the dense test oracle and QASM tooling."""
    m = np.asarray(matrix, dtype=np.complex128)
    dim = m.shape[0]
    full = np.eye(dim << num_controls, dtype=np.complex128)
    full[-dim:, -dim:] = m
    return full


def superop_targets(targets, num_qubits):
    """The doubled-register target list [targets, targets + N] a channel
    superoperator acts on (ref QuEST_common.c:601-640 allTargets layout).
    THE single definition — circuit/sharded/channel engines all use it."""
    return tuple(targets) + tuple(t + num_qubits for t in targets)

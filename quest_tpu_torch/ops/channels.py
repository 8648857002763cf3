"""Decoherence channels on density-matrix registers: the eager API.

A port of quest_tpu/ops/channels.py. Each function validates its
arguments with the reference's checks, then updates the density
register's planes in place on its device and returns the register
(QuEST.h decoherence doc-group):

  mix_dephasing(p):      rho -> (1-p) rho + p Z rho Z          (p <= 1/2)
  mix_two_qubit_dephasing: the off-diagonal blocks of either qubit
                         scaled by 1 - 4p/3                    (p <= 3/4)
  mix_depolarising(p):   rho -> (1-p) rho + p/3 (X, Y, Z terms) (p <= 3/4)
  mix_two_qubit_depolarising: uniform over the 15 non-identity
                         two-qubit Paulis                      (p <= 15/16)
  mix_damping(p):        K0 = [[1,0],[0,sqrt(1-p)]], K1 = [[0,sqrt(p)],[0,0]]
  mix_pauli(px,py,pz):   the 4-operator Kraus map (QuEST_common.c:675-695)
  mix_*kraus_map(ops):   the superoperator sum_k conj(K) (x) K

Dephasing scales the amplitudes whose row and column bits differ on a
target (views narrowed to those halves, QuEST_cpu.c:48-173); every other
channel is its superoperator (ops/matrices.py) on [targets, targets + N]
through apply.apply_matrix, as the reference reduces it
(QuEST_common.c:540-673).

On a sharded register (parallel.ShardedAmps) dephasing is the diagonal
it is on [targets, targets + N] and every other channel its
superoperator, each one GateOp through the sharded per-gate applier
(parallel/eager.py), so a channel on an outer (column-space) qubit that
falls on a global bit takes the engine's swap-to-local exchanges.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np

from quest_tpu_torch import precision
from quest_tpu_torch import validation as val
from quest_tpu_torch.ops import apply as A
from quest_tpu_torch.ops import matrices as M
from quest_tpu_torch.parallel import eager as SE


def _dephase(q, targets, fac: float):
    """Scale the amplitudes whose row and column bits differ on any of
    `targets` by `fac` (in the plane dtype), in place."""
    if SE.is_sharded(q):
        return SE.dephase(q, tuple(int(t) for t in targets), fac)
    n = q.num_state_qubits
    nq = n // 2
    qubits = tuple(t for t in targets) + tuple(t + nq for t in targets)
    f = float(q.real_dtype.type(fac))
    k = len(targets)
    for bits in itertools.product((0, 1), repeat=2 * k):
        rows, cols = bits[:k], bits[k:]
        if rows == cols:
            continue
        for xr, xi, _ in A.target_chunks(q.amps, n, (), qubits, bits):
            xr.mul_(f)
            xi.mul_(f)
    return q


def mix_dephasing(q, target: int, prob):
    val.validate_density_matr(q)
    val.validate_target(q, target)
    val.validate_one_qubit_dephase_prob(float(prob))
    return _dephase(q, (int(target),), 1.0 - 2.0 * float(prob))


def mix_two_qubit_dephasing(q, t1: int, t2: int, prob):
    val.validate_density_matr(q)
    val.validate_multi_targets(q, (t1, t2))
    val.validate_two_qubit_dephase_prob(float(prob))
    return _dephase(q, (int(t1), int(t2)), 1.0 - 4.0 * float(prob) / 3.0)


def _pauli_twirl_matrix(num_qubits: int) -> np.ndarray:
    """sum over the Pauli products P of conj(P) (x) P."""
    dim = 1 << num_qubits
    acc = np.zeros((dim * dim, dim * dim), dtype=np.complex128)
    if num_qubits == 1:
        group = list(M.PAULIS)
    else:   # matrix bit 0 = first target: the first target is the LSB factor
        group = [np.kron(p2, p1) for p2 in M.PAULIS for p1 in M.PAULIS]
    for p in group:
        acc += np.kron(np.conj(p), p)
    return acc


_TWIRL1 = _pauli_twirl_matrix(1)
_TWIRL2 = _pauli_twirl_matrix(2)


def _superop(q, targets, sup) -> object:
    """Apply superoperator `sup` (complex, or an (re, im) pair) on
    [targets, targets + N] in place."""
    if SE.is_sharded(q):
        from quest_tpu_torch.circuit import GateOp
        op = GateOp("superop", tuple(int(t) for t in targets),
                    operand=np.asarray(sup, dtype=np.complex128))
        return SE.apply_ops(q, [op], True)
    precision.ieee_fp32()
    A.apply_matrix(q.amps, q.num_state_qubits, sup,
                   M.superop_targets(tuple(int(t) for t in targets),
                                     q.num_qubits),
                   tier=precision.matmul_precision())
    return q


def mix_depolarising(q, target: int, prob):
    val.validate_density_matr(q)
    val.validate_target(q, target)
    p = float(prob)
    val.validate_one_qubit_depol_prob(p)
    eye = np.eye(4)
    return _superop(q, (target,), (1 - p) * eye + (p / 3) * (_TWIRL1 - eye))


def mix_two_qubit_depolarising(q, t1: int, t2: int, prob):
    val.validate_density_matr(q)
    val.validate_multi_targets(q, (t1, t2))
    p = float(prob)
    val.validate_two_qubit_depol_prob(p)
    eye = np.eye(16)
    return _superop(q, (t1, t2),
                    (1 - p) * eye + (p / 15) * (_TWIRL2 - eye))


def mix_damping(q, target: int, prob):
    val.validate_density_matr(q)
    val.validate_target(q, target)
    p = float(prob)
    val.validate_one_qubit_damping_prob(p)
    return _superop(q, (target,), M.kraus_superoperator(M.damping_kraus(p)))


def mix_pauli(q, target: int, prob_x, prob_y, prob_z):
    """The 4-operator Kraus map of Pauli error probabilities (ref
    densmatr_mixPauli, QuEST_common.c:675-695)."""
    val.validate_density_matr(q)
    val.validate_target(q, target)
    px, py, pz = float(prob_x), float(prob_y), float(prob_z)
    val.validate_pauli_probs(px, py, pz)
    return _superop(q, (target,),
                    M.kraus_superoperator(M.pauli_kraus(px, py, pz)))


def mix_kraus_map(q, target: int, ops: Sequence):
    val.validate_density_matr(q)
    val.validate_target(q, target)
    val.validate_kraus_ops(ops, 1, eps=val.eps_for(q), max_ops=4)
    return _superop(q, (target,), M.kraus_superoperator(ops))


def mix_two_qubit_kraus_map(q, t1: int, t2: int, ops: Sequence):
    val.validate_density_matr(q)
    val.validate_multi_targets(q, (t1, t2))
    val.validate_kraus_ops(ops, 2, eps=val.eps_for(q), max_ops=16)
    return _superop(q, (t1, t2), M.kraus_superoperator(ops))


def mix_multi_qubit_kraus_map(q, targets: Sequence[int], ops: Sequence):
    val.validate_density_matr(q)
    val.validate_multi_targets(q, targets)
    k = len(tuple(targets))
    val.validate_kraus_ops(ops, k, eps=val.eps_for(q), max_ops=1 << (2 * k))
    return _superop(q, tuple(targets), M.kraus_superoperator(ops))


def mix_density_matrix(q, prob, other):
    """rho -> (1-p) rho + p sigma, as rho + p (sigma - rho), in place a
    chunk at a time (ref densmatr_mixDensityMatrix)."""
    val.validate_density_matr(q)
    val.validate_density_matr(other)
    val.validate_match(q, other)
    val.validate_prob(float(prob))
    p = float(q.real_dtype.type(prob))
    if SE.is_sharded(q) or SE.is_sharded(other):
        return SE.mix_density(q, p, other)
    a = q.amps.reshape(-1)
    b = other.amps.reshape(-1).to(a.dtype)
    for s in range(0, a.numel(), A.CHUNK_AMPS):
        sl = slice(s, s + A.CHUNK_AMPS)
        a[sl] += p * (b[sl] - a[sl])
    return q

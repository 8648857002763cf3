"""The eager gate API: Qureg -> Qureg for the full QuEST gate set.

A port of quest_tpu/ops/gates.py. Each public QuEST gate (QuEST.h
doc-groups "unitaries" and "operators") has a function here that
validates its arguments with the reference's checks and messages, then
applies the gate at once, in place on the register's planes through the
ops/apply primitives, on the register's device, and returns the
register. On a density register a gate U on targets T also applies
conj(U) on the column-space copy T + N (QuEST.c:8-10), exactly as the
reference traces both halves into one program.

The reference caches one jitted worker per gate shape and keys it on
the apply-layer knobs; the workers here are plain functions over
ops/apply, so there is nothing to cache or key. Contractions run at the
session's matmul tier (precision.matmul_precision(), read per call).
Parameterised gates build their operator on the host in f64 and hand it
to the primitive, which rounds it to the plane dtype.

On a sharded register (parallel.ShardedAmps) each gate is one GateOp
through the sharded per-gate engine's applier (parallel/eager.py
apply_ops: `sharded._apply_gateop`, its density dual inline), so a gate
on a global qubit issues the reference's pair exchanges on the
register's mesh; nothing is built or cached per call.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from quest_tpu_torch import precision
from quest_tpu_torch import validation as val
from quest_tpu_torch.ops import apply as A
from quest_tpu_torch.ops import matrices as M
from quest_tpu_torch.parallel import eager as SE


def _shift(qubits, by: int):
    return tuple(q + by for q in qubits)


def _tier() -> str:
    precision.ieee_fp32()
    return precision.matmul_precision()


def _gateop(kind, targets, operand, controls=(), cstates=()):
    from quest_tpu_torch.circuit import GateOp
    return GateOp(kind, tuple(targets), tuple(controls), tuple(cstates),
                  operand)


def _run(q, op, targets, controls=(), cstates=None, diagonal=False):
    """Apply the matrix (or, `diagonal`, the diagonal) `op` to `targets`
    under `controls` in place; on a density register its conjugate on
    the column-space copy too. Returns `q`."""
    targets = tuple(int(t) for t in targets)
    controls = tuple(int(c) for c in controls)
    cstates = (tuple(int(s) for s in cstates) if cstates is not None
               else (1,) * len(controls))
    op = np.asarray(op, dtype=np.complex128)
    if SE.is_sharded(q):
        return SE.apply_ops(q, [_gateop("diagonal" if diagonal else "matrix",
                                        targets, op, controls, cstates)],
                            q.is_density)
    n = q.num_state_qubits
    amps = q.amps

    def one(mat, t, c):
        if diagonal:
            A.apply_diagonal(amps, n, mat, t, c, cstates)
        else:
            A.apply_matrix(amps, n, mat, t, c, cstates, _tier())
    one(op, targets, controls)
    if q.is_density:
        one(np.conj(op), _shift(targets, n // 2), _shift(controls, n // 2))
    return q


def _phase_all_ones(q, qubits, term: complex):
    n = q.num_state_qubits
    qubits = tuple(int(x) for x in qubits)
    if SE.is_sharded(q):
        return SE.apply_ops(q, [_gateop("allones", qubits, complex(term))],
                            q.is_density)
    A.apply_phase_on_all_ones(q.amps, n, qubits, term)
    if q.is_density:
        A.apply_phase_on_all_ones(q.amps, n, _shift(qubits, n // 2),
                                  np.conj(term))
    return q


# ---------------------------------------------------------------------------
# single-qubit unitaries (ref QuEST.c:109-331)
# ---------------------------------------------------------------------------


def compact_unitary(q, target: int, alpha, beta):
    val.validate_target(q, target)
    val.validate_unitary_complex_pair(alpha, beta, eps=val.eps_for(q))
    return _run(q, M.compact_unitary(alpha, beta), (target,))


def controlled_compact_unitary(q, control: int, target: int, alpha, beta):
    val.validate_control_target(q, control, target)
    val.validate_unitary_complex_pair(alpha, beta, eps=val.eps_for(q))
    return _run(q, M.compact_unitary(alpha, beta), (target,), (control,))


def unitary(q, target: int, matrix):
    val.validate_target(q, target)
    val.validate_unitary(matrix, 1, eps=val.eps_for(q))
    return _run(q, matrix, (target,))


def controlled_unitary(q, control: int, target: int, matrix):
    val.validate_control_target(q, control, target)
    val.validate_unitary(matrix, 1, eps=val.eps_for(q))
    return _run(q, matrix, (target,), (control,))


def multi_controlled_unitary(q, controls: Sequence[int], target: int, matrix):
    val.validate_multi_controls_targets(q, controls, (target,))
    val.validate_unitary(matrix, 1, eps=val.eps_for(q))
    return _run(q, matrix, (target,), tuple(controls))


def multi_state_controlled_unitary(q, controls: Sequence[int],
                                   control_states: Sequence[int],
                                   target: int, matrix):
    val.validate_multi_controls_targets(q, controls, (target,))
    val.validate_control_states(controls, control_states)
    val.validate_unitary(matrix, 1, eps=val.eps_for(q))
    return _run(q, matrix, (target,), tuple(controls), tuple(control_states))


def pauli_x(q, target: int):
    val.validate_target(q, target)
    return _run(q, M.PAULI_X, (target,))


def pauli_y(q, target: int):
    val.validate_target(q, target)
    return _run(q, M.PAULI_Y, (target,))


def pauli_z(q, target: int):
    val.validate_target(q, target)
    return _run(q, M.Z_DIAG, (target,), diagonal=True)


def hadamard(q, target: int):
    val.validate_target(q, target)
    return _run(q, M.HADAMARD, (target,))


def s_gate(q, target: int):
    val.validate_target(q, target)
    return _run(q, M.S_DIAG, (target,), diagonal=True)


def t_gate(q, target: int):
    val.validate_target(q, target)
    return _run(q, M.T_DIAG, (target,), diagonal=True)


def phase_shift(q, target: int, angle):
    val.validate_target(q, target)
    return _run(q, M.phase_diag(angle), (target,), diagonal=True)


def controlled_not(q, control: int, target: int):
    val.validate_control_target(q, control, target)
    return _run(q, M.PAULI_X, (target,), (control,))


def controlled_pauli_y(q, control: int, target: int):
    val.validate_control_target(q, control, target)
    return _run(q, M.PAULI_Y, (target,), (control,))


# -- rotations ---------------------------------------------------------------


def rotate_around_axis(q, target: int, angle, axis):
    val.validate_target(q, target)
    val.validate_vector(axis)
    return _run(q, M.rotation(float(angle), axis), (target,))


def rotate_x(q, target: int, angle):
    return rotate_around_axis(q, target, angle, (1.0, 0.0, 0.0))


def rotate_y(q, target: int, angle):
    return rotate_around_axis(q, target, angle, (0.0, 1.0, 0.0))


def rotate_z(q, target: int, angle):
    return rotate_around_axis(q, target, angle, (0.0, 0.0, 1.0))


def controlled_rotate_around_axis(q, control: int, target: int, angle, axis):
    val.validate_control_target(q, control, target)
    val.validate_vector(axis)
    return _run(q, M.rotation(float(angle), axis), (target,), (control,))


def controlled_rotate_x(q, control: int, target: int, angle):
    return controlled_rotate_around_axis(q, control, target, angle,
                                         (1.0, 0.0, 0.0))


def controlled_rotate_y(q, control: int, target: int, angle):
    return controlled_rotate_around_axis(q, control, target, angle,
                                         (0.0, 1.0, 0.0))


def controlled_rotate_z(q, control: int, target: int, angle):
    return controlled_rotate_around_axis(q, control, target, angle,
                                         (0.0, 0.0, 1.0))


# -- the symmetric phase family ----------------------------------------------


def controlled_phase_shift(q, qubit1: int, qubit2: int, angle):
    val.validate_unique_targets(q, qubit1, qubit2)
    return _phase_all_ones(q, (qubit1, qubit2), np.exp(1j * float(angle)))


def multi_controlled_phase_shift(q, qubits: Sequence[int], angle):
    val.validate_multi_targets(q, qubits)
    return _phase_all_ones(q, tuple(qubits), np.exp(1j * float(angle)))


def controlled_phase_flip(q, qubit1: int, qubit2: int):
    val.validate_unique_targets(q, qubit1, qubit2)
    return _phase_all_ones(q, (qubit1, qubit2), -1.0 + 0.0j)


def multi_controlled_phase_flip(q, qubits: Sequence[int]):
    val.validate_multi_targets(q, qubits)
    return _phase_all_ones(q, tuple(qubits), -1.0 + 0.0j)


def multi_rotate_z(q, qubits: Sequence[int], angle):
    """exp(-i angle/2 Z x ... x Z); its dual negates the angle."""
    val.validate_multi_targets(q, qubits)
    n = q.num_state_qubits
    qubits = tuple(int(x) for x in qubits)
    if SE.is_sharded(q):
        return SE.apply_ops(q, [_gateop("parity", qubits, float(angle))],
                            q.is_density)
    A.apply_parity_phase(q.amps, n, qubits, float(angle))
    if q.is_density:
        A.apply_parity_phase(q.amps, n, _shift(qubits, n // 2), -float(angle))
    return q


def _pauli_rotation(amps: torch.Tensor, n: int, term, angle: float,
                    conj: bool) -> None:
    """exp(-i angle/2 P) = cos(angle/2) - i sin(angle/2) P in one
    flip-form pass, in place (ref gates.py:_pauli_rot_worker); `conj`
    applies its complex conjugate, conj(P) = (-1)^ny P."""
    rdt = amps.dtype
    half = torch.tensor(float(angle), dtype=rdt) / 2.0
    c, s = float(torch.cos(half)), float(torch.sin(half))
    if conj and sum(1 for p in term if p == 2) % 2 == 0:
        s = -s
    for xr, xi, wr, wi in A.pauli_chunks(amps, n, term):
        nr = c * xr + s * wi
        ni = c * xi - s * wr
        xr.copy_(nr)
        xi.copy_(ni)


def multi_rotate_pauli(q, targets: Sequence[int], paulis: Sequence[int],
                       angle):
    """exp(-i angle/2 P1 x P2 x ...) in one flip-form pass per register
    side (the reference's eager form; its circuit builder rotates bases
    around a parity phase instead). An all-identity string is a no-op,
    as in the reference (QuEST_common.c:435-436)."""
    val.validate_multi_targets(q, targets)
    val.validate_pauli_targets(targets, paulis)
    val.validate_pauli_codes(paulis)
    n = q.num_state_qubits
    term = [0] * n
    for t, p in zip(targets, paulis):
        term[int(t)] = int(p)
    if not any(term):
        return q
    if SE.is_sharded(q):
        # basis rotations around a parity phase (Circuit.multi_rotate_pauli),
        # each through the sharded applier with its dual
        from quest_tpu_torch.circuit import Circuit
        c = Circuit(q.num_qubits).multi_rotate_pauli(
            tuple(int(t) for t in targets), tuple(int(p) for p in paulis),
            float(angle))
        return SE.apply_ops(q, c.ops, q.is_density)
    _pauli_rotation(q.amps, n, term, float(angle), conj=False)
    if q.is_density:
        dual = [0] * n
        for t, p in zip(targets, paulis):
            dual[int(t) + n // 2] = int(p)
        _pauli_rotation(q.amps, n, dual, float(angle), conj=True)
    return q


# -- multi-qubit unitaries ---------------------------------------------------


def swap_gate(q, qubit1: int, qubit2: int):
    val.validate_unique_targets(q, qubit1, qubit2)
    return _run(q, M.SWAP, (qubit1, qubit2))


def sqrt_swap_gate(q, qubit1: int, qubit2: int):
    val.validate_unique_targets(q, qubit1, qubit2)
    return _run(q, M.SQRT_SWAP, (qubit1, qubit2))


def two_qubit_unitary(q, target1: int, target2: int, matrix):
    val.validate_multi_targets(q, (target1, target2))
    val.validate_unitary(matrix, 2, eps=val.eps_for(q))
    return _run(q, matrix, (target1, target2))


def controlled_two_qubit_unitary(q, control: int, target1: int, target2: int,
                                 matrix):
    val.validate_multi_controls_targets(q, (control,), (target1, target2))
    val.validate_unitary(matrix, 2, eps=val.eps_for(q))
    return _run(q, matrix, (target1, target2), (control,))


def multi_controlled_two_qubit_unitary(q, controls: Sequence[int],
                                       target1: int, target2: int, matrix):
    val.validate_multi_controls_targets(q, controls, (target1, target2))
    val.validate_unitary(matrix, 2, eps=val.eps_for(q))
    return _run(q, matrix, (target1, target2), tuple(controls))


def multi_qubit_unitary(q, targets: Sequence[int], matrix):
    val.validate_multi_targets(q, targets)
    val.validate_unitary(matrix, len(tuple(targets)), eps=val.eps_for(q))
    return _run(q, matrix, tuple(targets))


def controlled_multi_qubit_unitary(q, control: int, targets: Sequence[int],
                                   matrix):
    val.validate_multi_controls_targets(q, (control,), targets)
    val.validate_unitary(matrix, len(tuple(targets)), eps=val.eps_for(q))
    return _run(q, matrix, tuple(targets), (control,))


def multi_controlled_multi_qubit_unitary(q, controls: Sequence[int],
                                         targets: Sequence[int], matrix):
    val.validate_multi_controls_targets(q, controls, targets)
    val.validate_unitary(matrix, len(tuple(targets)), eps=val.eps_for(q))
    return _run(q, matrix, tuple(targets), tuple(controls))


# -- non-unitary helpers -----------------------------------------------------


def apply_pauli_prod(q, targets: Sequence[int], paulis: Sequence[int]):
    """Left-multiply by a product of Paulis in one flip-form pass (ref
    statevec_applyPauliProd, QuEST_common.c:450-461); on a density
    register the row space only (P rho, not P rho P+), as the reference
    does."""
    val.validate_pauli_targets(targets, paulis)
    term = [0] * q.num_state_qubits
    for t, p in zip(targets, paulis):
        term[int(t)] = int(p)
    if SE.is_sharded(q):
        # one single-qubit Pauli a target (exact: each only permutes,
        # negates or multiplies by i); the row space only, no duals
        mats = {1: M.PAULI_X, 2: M.PAULI_Y}
        ops = [_gateop("diagonal", (t,), M.Z_DIAG) if p == 3
               else _gateop("matrix", (t,), mats[p])
               for t, p in enumerate(term) if p]
        return SE.apply_ops(q, ops, False)
    A.apply_pauli_string(q.amps, q.num_state_qubits, term)
    return q


def set_weighted_qureg(fac1, q1, fac2, q2, fac_out, out):
    """out = fac1 q1 + fac2 q2 + fac_out out, in place on `out`, a chunk
    at a time (ref QuEST_cpu.c:3579-3620)."""
    val.validate_match(q1, q2)
    val.validate_match(q1, out)
    val.validate_matching_types(q1, q2)
    val.validate_matching_types(q1, out)
    if SE.is_sharded(q1) or SE.is_sharded(q2) or SE.is_sharded(out):
        return SE.weighted((fac1, fac2, fac_out), (q1, q2), out)
    rdt = out.real_dtype
    f = [rdt.type(x) for c in (fac1, fac2, fac_out)
         for x in (complex(c).real, complex(c).imag)]
    o = out.amps.reshape(2, -1)
    a = q1.amps.reshape(2, -1).to(o.dtype)
    b = q2.amps.reshape(2, -1).to(o.dtype)
    step = A.CHUNK_AMPS

    def scale(re, im, fr, fi):
        return fr * re - fi * im, fr * im + fi * re
    for s in range(0, o.shape[1], step):
        sl = slice(s, s + step)
        ar, ai = scale(a[0, sl], a[1, sl], float(f[0]), float(f[1]))
        br, bi = scale(b[0, sl], b[1, sl], float(f[2]), float(f[3]))
        orr, oi = scale(o[0, sl], o[1, sl], float(f[4]), float(f[5]))
        o[0, sl] = ar + br + orr
        o[1, sl] = ai + bi + oi
    return out

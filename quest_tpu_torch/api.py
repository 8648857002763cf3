"""QuEST-compatible eager API: every public function of the reference's
QuEST.h (~105 functions in 9 doc groups, QuEST/include/QuEST.h:7-24),
with the reference's camelCase names and imperative calling convention,
over the port's functional layer.

A port of quest_tpu/api.py. Registers live on the env's device: the
CUDA card, unless the env was created with device="cpu". The port's
gates run in place on a register's planes, so no two handles ever share
planes: createCloneQureg and cloneQureg copy, and setWeightedQureg,
mixDensityMatrix and initPureState write into the target's own planes.

A `Qureg` here is a mutable HANDLE (state + QASM logger); each API call
validates, dispatches to the functional layer, rebinds the handle's state,
and records QASM — the same validate -> dispatch -> record pipeline as the
reference's front-end (QuEST/src/QuEST.c). Reference user code ports
line-for-line:

    C (reference)                         Python (this module)
    ------------------------------------  ------------------------------
    QuESTEnv env = createQuESTEnv();      env = createQuESTEnv()
    Qureg q = createQureg(3, env);        q = createQureg(3, env)
    hadamard(q, 0);                       hadamard(q, 0)
    int m = measure(q, 0);                m = measure(q, 0)
    destroyQureg(q, env);                 destroyQureg(q, env)

Data types map naturally: `Complex` -> python complex, `ComplexMatrix2/4/N`
-> numpy arrays (createComplexMatrixN below), `Vector` -> 3-sequence,
`pauliOpType` -> PAULI_I/X/Y/Z ints. The overridable error hook
`invalidQuESTInputError` (weak symbol in the reference,
QuEST.h:3163-3190) is `set_input_error_handler` here.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

import torch

from quest_tpu_torch import calculations as _calc
from quest_tpu_torch import env as _env
from quest_tpu_torch import measurement as _meas
from quest_tpu_torch import native as _native
from quest_tpu_torch import precision as _prec
from quest_tpu_torch import random_ as _rng
from quest_tpu_torch import state as _state
from quest_tpu_torch import validation as _val
from quest_tpu_torch.ops import channels as _chan
from quest_tpu_torch.ops import gates as _gates
from quest_tpu_torch.qasm import QASMLogger

# pauliOpType (ref QuEST.h:96)
PAULI_I, PAULI_X, PAULI_Y, PAULI_Z = 0, 1, 2, 3

QuESTEnv = _env.QuESTEnv


class Qureg:
    """Mutable register handle: functional state + QASM logger
    (ref Qureg, QuEST.h:160-191)."""

    def __init__(self, state: _state.Qureg, env: Optional[QuESTEnv] = None):
        self.state = state
        self.env = env
        self.qasm = QASMLogger(state.num_qubits)

    # convenience mirrors of the reference's struct fields
    @property
    def numQubitsRepresented(self) -> int:
        return self.state.num_qubits

    @property
    def isDensityMatrix(self) -> bool:
        return self.state.is_density

    @property
    def numAmpsTotal(self) -> int:
        return self.state.num_amps

    def _set(self, new_state: _state.Qureg) -> None:
        self.state = new_state


# ---------------------------------------------------------------------------
# environment (ref QuEST.h "init" group; QuEST_cpu_local.c:170-180)
# ---------------------------------------------------------------------------


def createQuESTEnv(**kwargs) -> QuESTEnv:
    return _env.create_quest_env(**kwargs)


def destroyQuESTEnv(env: QuESTEnv) -> None:
    _env.destroy_quest_env(env)


def syncQuESTEnv(env: QuESTEnv) -> None:
    env.sync()


def syncQuESTSuccess(successCode: int) -> int:
    return _env.sync_quest_success(successCode)


def reportQuESTEnv(env: QuESTEnv) -> None:
    env.report()


def getEnvironmentString(env: QuESTEnv, qureg: "Qureg" = None) -> str:
    # the reference formats qureg.numQubitsInStateVec — the DOUBLED count
    # for density matrices (QuEST_cpu.c:1363), not numQubitsRepresented
    n = qureg.state.num_state_qubits if qureg is not None else None
    return env.get_environment_string(n)


def seedQuEST(seeds: Sequence[int]) -> None:
    _rng.seed_quest(list(seeds))


def seedQuESTDefault() -> None:
    _rng.seed_quest_default()


# ---------------------------------------------------------------------------
# Qureg lifecycle (ref QuEST.c:34-78)
# ---------------------------------------------------------------------------


def _device(env: Optional[QuESTEnv]):
    return env.device if env is not None else _env.resolve_device(None)


def createQureg(numQubits: int, env: Optional[QuESTEnv] = None,
                dtype=None) -> Qureg:
    """A statevector on the env's device (default: the CUDA card), sharded
    over the env's mesh when it has one (QuESTEnv.sharding_for)."""
    return Qureg(_state.create_qureg(numQubits, env, dtype,
                                     device=_device(env)), env)


def createDensityQureg(numQubits: int, env: Optional[QuESTEnv] = None,
                       dtype=None) -> Qureg:
    return Qureg(_state.create_density_qureg(numQubits, env, dtype,
                                             device=_device(env)), env)


def createCloneQureg(qureg: Qureg, env: Optional[QuESTEnv] = None) -> Qureg:
    return Qureg(_state.clone(qureg.state), env if env is not None else qureg.env)


def destroyQureg(qureg: Qureg, env: Optional[QuESTEnv] = None) -> None:
    """Release the handle's device buffer (ref QuEST.c:74-78): the
    planes are freed once no tensor refers to them."""
    qureg.state = None


def cloneQureg(targetQureg: Qureg, copyQureg: Qureg) -> None:
    """Overwrite targetQureg's planes with a copy of copyQureg's (ref
    cloneQureg, QuEST.c works on matching-dimension registers)."""
    _val.validate_matching_types(targetQureg.state, copyQureg.state)
    _val.validate_match(targetQureg.state, copyQureg.state)
    targetQureg.state.amps.copy_(copyQureg.state.amps)


def reportQuregParams(qureg: Qureg) -> None:
    """(ref reportQuregParams, QuEST_common.c:233-242)"""
    n = qureg.state.num_state_qubits
    print("QUBITS:")
    print(f"Number of qubits is {n}.")
    print(f"Number of amps is {1 << n}.")


def getNumQubits(qureg: Qureg) -> int:
    return _state.get_num_qubits(qureg.state)


def getNumAmps(qureg: Qureg) -> int:
    return _state.get_num_amps(qureg.state)


# ---------------------------------------------------------------------------
# state initialisations (ref QuEST.c:109-161)
# ---------------------------------------------------------------------------


def initBlankState(qureg: Qureg) -> None:
    qureg._set(_state.init_blank_state(qureg.state))
    qureg.qasm.record_comment("Initialising state to all-zero amplitudes")


def initZeroState(qureg: Qureg) -> None:
    qureg._set(_state.init_zero_state(qureg.state))
    qureg.qasm.record_init_zero()


def initPlusState(qureg: Qureg) -> None:
    qureg._set(_state.init_plus_state(qureg.state))
    qureg.qasm.record_init_plus()


def initClassicalState(qureg: Qureg, stateInd: int) -> None:
    qureg._set(_state.init_classical_state(qureg.state, stateInd))
    qureg.qasm.record_init_classical(stateInd)


def initPureState(qureg: Qureg, pure: Qureg) -> None:
    qureg._set(_state.init_pure_state(qureg.state, pure.state))
    qureg.qasm.record_comment("Initialising state from purity")


def initDebugState(qureg: Qureg) -> None:
    qureg._set(_state.init_debug_state(qureg.state))
    qureg.qasm.record_comment(
        "Initialising state to debug state (amp[k] = (2k + (2k+1)i)/10)")


def initStateFromAmps(qureg: Qureg, reals, imags) -> None:
    qureg._set(_state.init_state_from_amps(qureg.state, reals, imags))
    qureg.qasm.record_comment("Initialising state from amplitude arrays")


def setAmps(qureg: Qureg, startInd: int, reals, imags, numAmps: int = None) -> None:
    reals = np.asarray(reals).reshape(-1)
    imags = np.asarray(imags).reshape(-1)
    if numAmps is not None:
        reals, imags = reals[:numAmps], imags[:numAmps]
    qureg._set(_state.set_amps(qureg.state, startInd, reals, imags))
    qureg.qasm.record_comment("Setting amplitude slice")


def setWeightedQureg(fac1, qureg1: Qureg, fac2, qureg2: Qureg,
                     facOut, out: Qureg) -> None:
    out._set(_gates.set_weighted_qureg(fac1, qureg1.state, fac2, qureg2.state,
                                       facOut, out.state))
    out.qasm.record_comment("Setting weighted sum of registers")


# ---------------------------------------------------------------------------
# amplitude getters (ref QuEST.c:671-705)
# ---------------------------------------------------------------------------


def getAmp(qureg: Qureg, index: int) -> complex:
    return _state.get_amp(qureg.state, index)


def getRealAmp(qureg: Qureg, index: int) -> float:
    return _state.get_real_amp(qureg.state, index)


def getImagAmp(qureg: Qureg, index: int) -> float:
    return _state.get_imag_amp(qureg.state, index)


def getProbAmp(qureg: Qureg, index: int) -> float:
    return _state.get_prob_amp(qureg.state, index)


def getDensityAmp(qureg: Qureg, row: int, col: int) -> complex:
    return _state.get_density_amp(qureg.state, row, col)


# ---------------------------------------------------------------------------
# ComplexMatrixN (ref QuEST.h:3233-3291, QuEST.c createComplexMatrixN)
# ---------------------------------------------------------------------------


def createComplexMatrixN(numQubits: int) -> np.ndarray:
    """A zeroed (2^n, 2^n) complex matrix (ref createComplexMatrixN)."""
    if numQubits < 1:
        _val.err(
            "Invalid number of qubits: must create a matrix of at least 1 qubit")
    dim = 1 << numQubits
    return np.zeros((dim, dim), dtype=np.complex128)


def destroyComplexMatrixN(matrix) -> None:
    """No-op (numpy GC); kept for API parity."""


def initComplexMatrixN(matrix: np.ndarray, reals, imags) -> None:
    """Overwrite a ComplexMatrixN in place from real/imag 2-D arrays."""
    matrix[...] = np.asarray(reals) + 1j * np.asarray(imags)


def bindArraysToStackComplexMatrixN(numQubits: int, reals, imags,
                                    reStorage=None, imStorage=None) -> np.ndarray:
    """Build a ComplexMatrixN view from row arrays (the stack-allocation
    macro analogue, QuEST.h:3233-3291)."""
    return np.asarray(reals, dtype=np.float64) + \
        1j * np.asarray(imags, dtype=np.float64)


def getStaticComplexMatrixN(numQubits: int, reals, imags) -> np.ndarray:
    return bindArraysToStackComplexMatrixN(numQubits, reals, imags)


# ---------------------------------------------------------------------------
# unitaries (ref QuEST.c:109-520) — validate -> dispatch -> QASM
# ---------------------------------------------------------------------------


def compactUnitary(qureg: Qureg, targetQubit: int, alpha, beta) -> None:
    qureg._set(_gates.compact_unitary(qureg.state, targetQubit, alpha, beta))
    qureg.qasm.record_compact_unitary(alpha, beta, targetQubit)


def controlledCompactUnitary(qureg: Qureg, controlQubit: int,
                             targetQubit: int, alpha, beta) -> None:
    qureg._set(_gates.controlled_compact_unitary(
        qureg.state, controlQubit, targetQubit, alpha, beta))
    qureg.qasm.record_compact_unitary(alpha, beta, targetQubit,
                                      (controlQubit,))


def unitary(qureg: Qureg, targetQubit: int, u) -> None:
    qureg._set(_gates.unitary(qureg.state, targetQubit, u))
    qureg.qasm.record_unitary(u, targetQubit)


def controlledUnitary(qureg: Qureg, controlQubit: int, targetQubit: int, u) -> None:
    qureg._set(_gates.controlled_unitary(qureg.state, controlQubit,
                                         targetQubit, u))
    qureg.qasm.record_unitary(u, targetQubit, (controlQubit,))


def multiControlledUnitary(qureg: Qureg, controlQubits: Sequence[int],
                           numControlQubits: int = None, targetQubit: int = None,
                           u=None) -> None:
    # support both (q, ctrls, nCtrls, targ, u) [C signature] and
    # (q, ctrls, targ, u) [natural Python]
    if u is None:
        u = targetQubit
        targetQubit = numControlQubits
    else:
        controlQubits = list(controlQubits)[:numControlQubits]
    qureg._set(_gates.multi_controlled_unitary(qureg.state, controlQubits,
                                               targetQubit, u))
    qureg.qasm.record_unitary(u, targetQubit, tuple(controlQubits))


def multiStateControlledUnitary(qureg: Qureg, controlQubits: Sequence[int],
                                controlState: Sequence[int],
                                targetQubit: int, u) -> None:
    qureg._set(_gates.multi_state_controlled_unitary(
        qureg.state, controlQubits, controlState, targetQubit, u))
    qureg.qasm.record_multi_state_controlled_unitary(
        u, tuple(controlQubits), tuple(controlState), targetQubit)


def pauliX(qureg: Qureg, targetQubit: int) -> None:
    qureg._set(_gates.pauli_x(qureg.state, targetQubit))
    qureg.qasm.record_gate("x", targetQubit)


def pauliY(qureg: Qureg, targetQubit: int) -> None:
    qureg._set(_gates.pauli_y(qureg.state, targetQubit))
    qureg.qasm.record_gate("y", targetQubit)


def pauliZ(qureg: Qureg, targetQubit: int) -> None:
    qureg._set(_gates.pauli_z(qureg.state, targetQubit))
    qureg.qasm.record_gate("z", targetQubit)


def hadamard(qureg: Qureg, targetQubit: int) -> None:
    qureg._set(_gates.hadamard(qureg.state, targetQubit))
    qureg.qasm.record_gate("h", targetQubit)


def sGate(qureg: Qureg, targetQubit: int) -> None:
    qureg._set(_gates.s_gate(qureg.state, targetQubit))
    qureg.qasm.record_gate("s", targetQubit)


def tGate(qureg: Qureg, targetQubit: int) -> None:
    qureg._set(_gates.t_gate(qureg.state, targetQubit))
    qureg.qasm.record_gate("t", targetQubit)


def phaseShift(qureg: Qureg, targetQubit: int, angle: float) -> None:
    qureg._set(_gates.phase_shift(qureg.state, targetQubit, angle))
    qureg.qasm.record_gate("phase", targetQubit, params=(angle,))


def controlledPhaseShift(qureg: Qureg, idQubit1: int, idQubit2: int,
                         angle: float) -> None:
    qureg._set(_gates.controlled_phase_shift(qureg.state, idQubit1, idQubit2,
                                             angle))
    qureg.qasm.record_gate("phase", idQubit2, (idQubit1,), (angle,))


def multiControlledPhaseShift(qureg: Qureg, controlQubits: Sequence[int],
                              numControlQubits: int = None,
                              angle: float = None) -> None:
    if angle is None:
        angle = numControlQubits
    else:
        controlQubits = list(controlQubits)[:numControlQubits]
    qubits = list(controlQubits)
    qureg._set(_gates.multi_controlled_phase_shift(qureg.state, qubits, angle))
    qureg.qasm.record_gate("phase", qubits[-1], tuple(qubits[:-1]), (angle,))


def controlledPhaseFlip(qureg: Qureg, idQubit1: int, idQubit2: int) -> None:
    qureg._set(_gates.controlled_phase_flip(qureg.state, idQubit1, idQubit2))
    qureg.qasm.record_gate("z", idQubit2, (idQubit1,))


def multiControlledPhaseFlip(qureg: Qureg, controlQubits: Sequence[int],
                             numControlQubits: int = None) -> None:
    if numControlQubits is not None:
        controlQubits = list(controlQubits)[:numControlQubits]
    qubits = list(controlQubits)
    qureg._set(_gates.multi_controlled_phase_flip(qureg.state, qubits))
    qureg.qasm.record_gate("z", qubits[-1], tuple(qubits[:-1]))


def controlledNot(qureg: Qureg, controlQubit: int, targetQubit: int) -> None:
    qureg._set(_gates.controlled_not(qureg.state, controlQubit, targetQubit))
    qureg.qasm.record_gate("x", targetQubit, (controlQubit,))


def controlledPauliY(qureg: Qureg, controlQubit: int, targetQubit: int) -> None:
    qureg._set(_gates.controlled_pauli_y(qureg.state, controlQubit,
                                         targetQubit))
    qureg.qasm.record_gate("y", targetQubit, (controlQubit,))


def rotateX(qureg: Qureg, rotQubit: int, angle: float) -> None:
    qureg._set(_gates.rotate_x(qureg.state, rotQubit, angle))
    qureg.qasm.record_gate("rx", rotQubit, params=(angle,))


def rotateY(qureg: Qureg, rotQubit: int, angle: float) -> None:
    qureg._set(_gates.rotate_y(qureg.state, rotQubit, angle))
    qureg.qasm.record_gate("ry", rotQubit, params=(angle,))


def rotateZ(qureg: Qureg, rotQubit: int, angle: float) -> None:
    qureg._set(_gates.rotate_z(qureg.state, rotQubit, angle))
    qureg.qasm.record_gate("rz", rotQubit, params=(angle,))


def rotateAroundAxis(qureg: Qureg, rotQubit: int, angle: float, axis) -> None:
    axis = _as_axis(axis)
    qureg._set(_gates.rotate_around_axis(qureg.state, rotQubit, angle, axis))
    qureg.qasm.record_axis_rotation(angle, axis, rotQubit)


def controlledRotateX(qureg: Qureg, controlQubit: int, targetQubit: int,
                      angle: float) -> None:
    qureg._set(_gates.controlled_rotate_x(qureg.state, controlQubit,
                                          targetQubit, angle))
    qureg.qasm.record_gate("rx", targetQubit, (controlQubit,), (angle,))


def controlledRotateY(qureg: Qureg, controlQubit: int, targetQubit: int,
                      angle: float) -> None:
    qureg._set(_gates.controlled_rotate_y(qureg.state, controlQubit,
                                          targetQubit, angle))
    qureg.qasm.record_gate("ry", targetQubit, (controlQubit,), (angle,))


def controlledRotateZ(qureg: Qureg, controlQubit: int, targetQubit: int,
                      angle: float) -> None:
    qureg._set(_gates.controlled_rotate_z(qureg.state, controlQubit,
                                          targetQubit, angle))
    qureg.qasm.record_gate("rz", targetQubit, (controlQubit,), (angle,))


def controlledRotateAroundAxis(qureg: Qureg, controlQubit: int,
                               targetQubit: int, angle: float, axis) -> None:
    axis = _as_axis(axis)
    qureg._set(_gates.controlled_rotate_around_axis(
        qureg.state, controlQubit, targetQubit, angle, axis))
    qureg.qasm.record_axis_rotation(angle, axis, targetQubit, (controlQubit,))


def multiRotateZ(qureg: Qureg, qubits: Sequence[int], numQubits: int = None,
                 angle: float = None) -> None:
    if angle is None:
        angle = numQubits
    else:
        qubits = list(qubits)[:numQubits]
    qureg._set(_gates.multi_rotate_z(qureg.state, list(qubits), angle))
    qureg.qasm.record_comment(
        f"Here a multiRotateZ of angle {angle:g} was applied to qubits "
        f"{list(qubits)}")


def multiRotatePauli(qureg: Qureg, targetQubits: Sequence[int],
                     targetPaulis: Sequence[int], numTargets: int = None,
                     angle: float = None) -> None:
    if angle is None:
        angle = numTargets
    else:
        targetQubits = list(targetQubits)[:numTargets]
        targetPaulis = list(targetPaulis)[:numTargets]
    qureg._set(_gates.multi_rotate_pauli(qureg.state, list(targetQubits),
                                         list(targetPaulis), angle))
    qureg.qasm.record_comment(
        f"Here a multiRotatePauli of angle {angle:g} was applied")


def swapGate(qureg: Qureg, qubit1: int, qubit2: int) -> None:
    qureg._set(_gates.swap_gate(qureg.state, qubit1, qubit2))
    qureg.qasm.record_gate("swap", qubit2, (qubit1,))


def sqrtSwapGate(qureg: Qureg, qubit1: int, qubit2: int) -> None:
    qureg._set(_gates.sqrt_swap_gate(qureg.state, qubit1, qubit2))
    qureg.qasm.record_gate("sqrtswap", qubit2, (qubit1,))


def twoQubitUnitary(qureg: Qureg, targetQubit1: int, targetQubit2: int, u) -> None:
    qureg._set(_gates.two_qubit_unitary(qureg.state, targetQubit1,
                                        targetQubit2, u))
    qureg.qasm.record_comment(
        "Here a two-qubit unitary was applied (no QASM equivalent)")


def controlledTwoQubitUnitary(qureg: Qureg, controlQubit: int,
                              targetQubit1: int, targetQubit2: int, u) -> None:
    qureg._set(_gates.controlled_two_qubit_unitary(
        qureg.state, controlQubit, targetQubit1, targetQubit2, u))
    qureg.qasm.record_comment(
        "Here a controlled two-qubit unitary was applied (no QASM equivalent)")


def multiControlledTwoQubitUnitary(qureg: Qureg, controlQubits: Sequence[int],
                                   numControlQubits: int = None,
                                   targetQubit1: int = None,
                                   targetQubit2: int = None, u=None) -> None:
    if u is None:
        u = targetQubit2
        targetQubit2 = targetQubit1
        targetQubit1 = numControlQubits
    else:
        controlQubits = list(controlQubits)[:numControlQubits]
    qureg._set(_gates.multi_controlled_two_qubit_unitary(
        qureg.state, list(controlQubits), targetQubit1, targetQubit2, u))
    qureg.qasm.record_comment(
        "Here a multi-controlled two-qubit unitary was applied "
        "(no QASM equivalent)")


def multiQubitUnitary(qureg: Qureg, targs: Sequence[int],
                      numTargs: int = None, u=None) -> None:
    if u is None:
        u = numTargs
    else:
        targs = list(targs)[:numTargs]
    qureg._set(_gates.multi_qubit_unitary(qureg.state, list(targs), u))
    qureg.qasm.record_comment(
        "Here a multi-qubit unitary was applied (no QASM equivalent)")


def controlledMultiQubitUnitary(qureg: Qureg, ctrl: int, targs: Sequence[int],
                                numTargs: int = None, u=None) -> None:
    if u is None:
        u = numTargs
    else:
        targs = list(targs)[:numTargs]
    qureg._set(_gates.controlled_multi_qubit_unitary(qureg.state, ctrl,
                                                     list(targs), u))
    qureg.qasm.record_comment(
        "Here a controlled multi-qubit unitary was applied "
        "(no QASM equivalent)")


def multiControlledMultiQubitUnitary(qureg: Qureg, ctrls: Sequence[int],
                                     numCtrls: int = None,
                                     targs: Sequence[int] = None,
                                     numTargs: int = None, u=None) -> None:
    if u is None:
        u = targs
        targs = numCtrls
    else:
        ctrls = list(ctrls)[:numCtrls]
        targs = list(targs)[:numTargs]
    qureg._set(_gates.multi_controlled_multi_qubit_unitary(
        qureg.state, list(ctrls), list(targs), u))
    qureg.qasm.record_comment(
        "Here a multi-controlled multi-qubit unitary was applied "
        "(no QASM equivalent)")


def _as_axis(axis):
    if hasattr(axis, "x"):
        return (axis.x, axis.y, axis.z)
    return tuple(axis)


# ---------------------------------------------------------------------------
# decoherence (ref QuEST.c:890-1000)
# ---------------------------------------------------------------------------


def mixDephasing(qureg: Qureg, targetQubit: int, prob: float) -> None:
    qureg._set(_chan.mix_dephasing(qureg.state, targetQubit, prob))
    qureg.qasm.record_comment(
        f"Here, a phase damping of probability {prob:g} was applied")


def mixTwoQubitDephasing(qureg: Qureg, qubit1: int, qubit2: int,
                         prob: float) -> None:
    qureg._set(_chan.mix_two_qubit_dephasing(qureg.state, qubit1, qubit2, prob))
    qureg.qasm.record_comment(
        f"Here, a two-qubit phase damping of probability {prob:g} was applied")


def mixDepolarising(qureg: Qureg, targetQubit: int, prob: float) -> None:
    qureg._set(_chan.mix_depolarising(qureg.state, targetQubit, prob))
    qureg.qasm.record_comment(
        f"Here, a depolarising of probability {prob:g} was applied")


def mixTwoQubitDepolarising(qureg: Qureg, qubit1: int, qubit2: int,
                            prob: float) -> None:
    qureg._set(_chan.mix_two_qubit_depolarising(qureg.state, qubit1, qubit2,
                                                prob))
    qureg.qasm.record_comment(
        f"Here, a two-qubit depolarising of probability {prob:g} was applied")


def mixDamping(qureg: Qureg, targetQubit: int, prob: float) -> None:
    qureg._set(_chan.mix_damping(qureg.state, targetQubit, prob))
    qureg.qasm.record_comment(
        f"Here, an amplitude damping of probability {prob:g} was applied")


def mixPauli(qureg: Qureg, targetQubit: int, probX: float, probY: float,
             probZ: float) -> None:
    qureg._set(_chan.mix_pauli(qureg.state, targetQubit, probX, probY, probZ))
    qureg.qasm.record_comment("Here, a Pauli error channel was applied")


def mixKrausMap(qureg: Qureg, targetQubit: int, ops, numOps: int = None) -> None:
    if numOps is not None:
        ops = list(ops)[:numOps]
    qureg._set(_chan.mix_kraus_map(qureg.state, targetQubit, ops))
    qureg.qasm.record_comment("Here, a Kraus map was applied")


def mixTwoQubitKrausMap(qureg: Qureg, qubit1: int, qubit2: int, ops,
                        numOps: int = None) -> None:
    if numOps is not None:
        ops = list(ops)[:numOps]
    qureg._set(_chan.mix_two_qubit_kraus_map(qureg.state, qubit1, qubit2, ops))
    qureg.qasm.record_comment("Here, a two-qubit Kraus map was applied")


def mixMultiQubitKrausMap(qureg: Qureg, targets: Sequence[int],
                          numTargets: int = None, ops=None,
                          numOps: int = None) -> None:
    if ops is None:
        ops = numTargets
    else:
        targets = list(targets)[:numTargets]
        if numOps is not None:
            ops = list(ops)[:numOps]
    qureg._set(_chan.mix_multi_qubit_kraus_map(qureg.state, list(targets), ops))
    qureg.qasm.record_comment("Here, a multi-qubit Kraus map was applied")


def mixDensityMatrix(combineQureg: Qureg, prob: float, otherQureg: Qureg) -> None:
    combineQureg._set(_chan.mix_density_matrix(combineQureg.state, prob,
                                               otherQureg.state))
    combineQureg.qasm.record_comment(
        f"Here, the register was mixed with probability {prob:g}")


# ---------------------------------------------------------------------------
# calculations (ref QuEST.c:790-887)
# ---------------------------------------------------------------------------


def calcTotalProb(qureg: Qureg) -> float:
    return _calc.calc_total_prob(qureg.state)


def calcInnerProduct(bra: Qureg, ket: Qureg) -> complex:
    return _calc.calc_inner_product(bra.state, ket.state)


def calcDensityInnerProduct(rho1: Qureg, rho2: Qureg) -> float:
    return _calc.calc_density_inner_product(rho1.state, rho2.state)


def calcPurity(qureg: Qureg) -> float:
    return _calc.calc_purity(qureg.state)


def calcFidelity(qureg: Qureg, pureState: Qureg) -> float:
    return _calc.calc_fidelity(qureg.state, pureState.state)


def calcHilbertSchmidtDistance(a: Qureg, b: Qureg) -> float:
    return _calc.calc_hilbert_schmidt_distance(a.state, b.state)


def calcExpecPauliProd(qureg: Qureg, targetQubits: Sequence[int],
                       pauliCodes: Sequence[int], numTargets: int = None,
                       workspace: Qureg = None) -> float:
    if numTargets is not None:
        targetQubits = list(targetQubits)[:numTargets]
        pauliCodes = list(pauliCodes)[:numTargets]
    return _calc.calc_expec_pauli_prod(qureg.state, list(targetQubits),
                                       list(pauliCodes))


def calcExpecPauliSum(qureg: Qureg, allPauliCodes, termCoeffs,
                      numSumTerms: int = None, workspace: Qureg = None) -> float:
    codes = np.asarray(allPauliCodes).reshape(-1)
    coeffs = np.asarray(termCoeffs).reshape(-1)
    if numSumTerms is not None:
        codes = codes[:numSumTerms * qureg.numQubitsRepresented]
        coeffs = coeffs[:numSumTerms]
    return _calc.calc_expec_pauli_sum(qureg.state, codes, coeffs)


def calcProbOfOutcome(qureg: Qureg, measureQubit: int, outcome: int) -> float:
    return _meas.calc_prob_of_outcome(qureg.state, measureQubit, outcome)


def applyPauliSum(inQureg: Qureg, allPauliCodes, termCoeffs,
                  numSumTerms: int = None, outQureg: Qureg = None) -> None:
    codes = np.asarray(allPauliCodes).reshape(-1)
    coeffs = np.asarray(termCoeffs).reshape(-1)
    if numSumTerms is not None:
        codes = codes[:numSumTerms * inQureg.numQubitsRepresented]
        coeffs = coeffs[:numSumTerms]
    result = _calc.apply_pauli_sum(inQureg.state, codes, coeffs)
    if outQureg is None:
        outQureg = inQureg
    outQureg._set(result)


# ---------------------------------------------------------------------------
# gates: measurement (ref QuEST.c:756-777)
# ---------------------------------------------------------------------------


def measure(qureg: Qureg, measureQubit: int) -> int:
    new_state, outcome = _meas.measure(qureg.state, measureQubit)
    qureg._set(new_state)
    qureg.qasm.record_measurement(measureQubit)
    return outcome


def measureWithStats(qureg: Qureg, measureQubit: int):
    """Returns (outcome, outcomeProb) — the C out-param becomes a tuple."""
    new_state, outcome, prob = _meas.measure_with_stats(qureg.state,
                                                        measureQubit)
    qureg._set(new_state)
    qureg.qasm.record_measurement(measureQubit)
    return outcome, prob


def collapseToOutcome(qureg: Qureg, measureQubit: int, outcome: int) -> float:
    new_state, prob = _meas.collapse_to_outcome(qureg.state, measureQubit,
                                                outcome)
    qureg._set(new_state)
    qureg.qasm.record_measurement(measureQubit)
    return prob


# ---------------------------------------------------------------------------
# QASM (ref QuEST.c:85-104)
# ---------------------------------------------------------------------------


def startRecordingQASM(qureg: Qureg) -> None:
    qureg.qasm.start_recording()


def stopRecordingQASM(qureg: Qureg) -> None:
    qureg.qasm.stop_recording()


def clearRecordedQASM(qureg: Qureg) -> None:
    qureg.qasm.clear()


def printRecordedQASM(qureg: Qureg) -> None:
    qureg.qasm.print_recorded()


def writeRecordedQASMToFile(qureg: Qureg, filename: str) -> None:
    if not qureg.qasm.write_recorded_to_file(filename):
        _val.err("Could not open file" + f" \"{filename}\"")


# ---------------------------------------------------------------------------
# device-copy analogues (ref copyStateToGPU/FromGPU, QuEST_gpu.cu:399-418).
# The planes live on the device for good; these synchronize instead.
# ---------------------------------------------------------------------------


def _sync(qureg: Qureg) -> None:
    if qureg.state.amps.is_cuda:
        torch.cuda.synchronize(qureg.state.amps.device)


def copyStateToGPU(qureg: Qureg) -> None:
    _sync(qureg)


def copyStateFromGPU(qureg: Qureg) -> None:
    _sync(qureg)


# ---------------------------------------------------------------------------
# debug / reporting (ref QuEST_debug.h, QuEST_common.c:215-242)
# ---------------------------------------------------------------------------


REPORT_CHUNK_AMPS = 1 << 20     # amplitudes reportState stages at a time


def reportState(qureg: Qureg) -> None:
    """Write all amplitudes to state_rank_0.csv in the reference's text
    (ref reportState, QuEST_common.c:215-231; quest_tpu/api.py:798-830):
    a "real, imag" header, then "%.12f, %.12f" rows, through the native
    CSV writer (native/quest_host.cpp), or in Python when the library is
    unavailable (native.warn_degraded says so once). The planes come to
    the host in <= 2^20-amplitude slices, the first written and the rest
    appended, so host memory stays bounded at 30 qubits."""
    amps = qureg.state.amps.reshape(2, -1)
    total = qureg.state.num_amps
    chunk = min(total, REPORT_CHUNK_AMPS)
    path = "state_rank_0.csv"
    use_native = _native.available()
    if not use_native:
        _native.warn_degraded("reportState")
    f = None if use_native else open(path, "w")
    try:
        if f is not None:
            f.write("real, imag\n")
        for lo in range(0, total, chunk):
            planes = amps[:, lo:lo + chunk].detach().cpu().numpy().astype(
                np.float64)
            if f is not None:
                f.writelines(f"{r:.12f}, {i:.12f}\n"
                             for r, i in zip(planes[0], planes[1]))
                continue
            ok = (_native.write_state_csv(path, planes[0], planes[1])
                  if lo == 0 else
                  _native.append_state_csv(path, planes[0], planes[1]))
            if not ok:
                raise OSError(f"native CSV writer failed at offset {lo}")
    finally:
        if f is not None:
            f.close()


def reportStateToScreen(qureg: Qureg, env: QuESTEnv = None,
                        reportRank: int = 0) -> None:
    """Print amplitudes (<=5 qubits, like the reference's guard,
    QuEST_cpu.c:1334-1357)."""
    print("Reporting state from rank 0:")
    # the reference guards on the full state-vector qubit count, so density
    # registers of >2 represented qubits refuse too (QuEST_cpu.c:1337)
    if qureg.state.num_state_qubits > 5:
        print("(state too large to print)")
        return
    vec = _state.to_dense(qureg.state).reshape(-1, order="F")
    for a in vec:
        print(f"{a.real:.12f}, {a.imag:.12f}")


def initStateDebug(qureg: Qureg) -> None:
    initDebugState(qureg)


def initStateOfSingleQubit(qureg: Qureg, qubitId: int, outcome: int) -> None:
    """Uniform superposition over basis states with bit `qubitId` == outcome
    (ref statevec_initStateOfSingleQubit, QuEST_cpu.c:1513-1555). Device-side
    construction — no 2^n host materialization at 30q."""
    qureg._set(_state.init_state_of_single_qubit(qureg.state, qubitId, outcome))


def initStateFromSingleFile(qureg: Qureg, filename: str,
                            env: QuESTEnv = None) -> bool:
    """Read a state from a CSV of 'real, imag' lines (ref
    statevec_initStateFromSingleFile, QuEST_cpu.c:1593-1642), through the
    native CSV reader, as the reference does (quest_tpu/api.py:850-870):
    a file the native reader cannot read whole is read again in Python.
    When the library is unavailable, the Python reader runs alone
    (native.warn_degraded says so once)."""
    if _native.available():
        pair = (_native.read_state_csv(filename, qureg.state.num_amps)
                if os.path.exists(filename) else None)
        if pair is not None:
            qureg._set(_state.init_state_from_amps(qureg.state, pair[0],
                                                   pair[1]))
            return True
    else:
        _native.warn_degraded("initStateFromSingleFile")
    reals, imags = [], []
    need = qureg.state.num_amps
    try:
        with open(filename) as f:
            for line in f:
                if len(reals) == need:  # extra rows ignored, like the ref
                    break
                line = line.strip()
                if not line or line.startswith("real"):
                    continue
                parts = line.replace(",", " ").split()
                if len(parts) < 2:
                    continue
                try:  # comment/header lines are legal, skip them
                    r, i = float(parts[0]), float(parts[1])
                except ValueError:
                    continue
                reals.append(r)
                imags.append(i)
    except OSError:
        return False
    if len(reals) != need:
        return False
    qureg._set(_state.init_state_from_amps(qureg.state, reals, imags))
    return True


def setDensityAmps(qureg: Qureg, reals, imags) -> None:
    """Overwrite all density-matrix amplitudes (ref setDensityAmps,
    QuEST_debug.h:44-48)."""
    qureg._set(_state.set_density_amps(qureg.state, 0, 0, reals, imags))


def compareStates(mq1: Qureg, mq2: Qureg, precision: float) -> bool:
    """Amplitude-wise comparison within precision (ref compareStates,
    QuEST_debug.h:30-33)."""
    a = _state.to_dense(mq1.state)
    b = _state.to_dense(mq2.state)
    return bool(np.all(np.abs(a - b) <= precision))


def QuESTPrecision() -> int:
    """1 for f32 planes, 2 for f64 (ref QuEST_debug.h:54): the precision
    of the registers createQureg makes by default."""
    return 1 if _prec.get_default_dtype() == np.dtype(np.complex64) else 2


# ---------------------------------------------------------------------------
# error hook (ref invalidQuESTInputError, QuEST.h:3163-3190)
# ---------------------------------------------------------------------------


def set_input_error_handler(handler) -> None:
    """Override what happens on invalid input (the reference's weak-symbol
    invalidQuESTInputError). handler(errMsg, errFunc) may raise or exit."""
    _val.set_error_handler(handler)


def invalidQuESTInputError(errMsg: str, errFunc: str) -> None:
    """The error hook, called (by late lookup, so replacing this module
    attribute overrides it, as redefining the reference's weak symbol
    does, QuEST.h:3163-3190) for every invalid input before the default
    handler raises QuESTError with the reference's message. It returns
    by default; an override may raise its own error."""

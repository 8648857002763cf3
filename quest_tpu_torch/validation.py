"""Input validation: the QuESTError type and the reference codes the
port raises.

The codes and messages are the subset of quest_tpu/validation.py's
verbatim QuEST table (QuEST_validation.c:26-131) that the port's circuit
builder, channel builders, register constructors and getters raise,
with the same numeric values, so a caller matching on `err.code` sees
the same code from either package.
"""

from __future__ import annotations

import enum

import numpy as np


class ErrorCode(enum.Enum):
    """Reference error codes (values as in QuEST_validation.c:26-79)."""
    E_INVALID_NUM_CREATE_QUBITS = 2
    E_INVALID_TARGET_QUBIT = 4
    E_INVALID_CONTROL_QUBIT = 5
    E_INVALID_STATE_INDEX = 6
    E_INVALID_AMP_INDEX = 7
    E_CONTROL_TARGET_COLLISION = 12
    E_TARGETS_NOT_UNIQUE = 14
    E_CONTROLS_NOT_UNIQUE = 15
    E_DEFINED_ONLY_FOR_DENSMATRS = 30
    E_INVALID_PROB = 31
    E_INVALID_ONE_QUBIT_DEPHASE_PROB = 33
    E_INVALID_TWO_QUBIT_DEPHASE_PROB = 34
    E_INVALID_ONE_QUBIT_DEPOL_PROB = 35
    E_INVALID_TWO_QUBIT_DEPOL_PROB = 36
    E_INVALID_CONTROLS_BIT_STATE = 38
    E_INVALID_NUM_ONE_QUBIT_KRAUS_OPS = 44
    E_INVALID_NUM_TWO_QUBIT_KRAUS_OPS = 45
    E_INVALID_NUM_N_QUBIT_KRAUS_OPS = 46
    E_INVALID_KRAUS_OPS = 47
    E_MISMATCHING_NUM_TARGS_KRAUS_SIZE = 48
    E_NUM_AMPS_EXCEED_TYPE = 50


E = ErrorCode

MESSAGES = {
    E.E_INVALID_NUM_CREATE_QUBITS: "Invalid number of qubits. Must create >0.",
    E.E_INVALID_TARGET_QUBIT: "Invalid target qubit. Must be >=0 and <numQubits.",
    E.E_INVALID_CONTROL_QUBIT: "Invalid control qubit. Must be >=0 and <numQubits.",
    E.E_INVALID_STATE_INDEX: "Invalid state index. Must be >=0 and <2^numQubits.",
    E.E_INVALID_AMP_INDEX: "Invalid amplitude index. Must be >=0 and <2^numQubits.",
    E.E_CONTROL_TARGET_COLLISION: "Control and target qubits must be disjoint.",
    E.E_TARGETS_NOT_UNIQUE: "The target qubits must be unique.",
    E.E_CONTROLS_NOT_UNIQUE: "The control qubits should be unique.",
    E.E_DEFINED_ONLY_FOR_DENSMATRS: "Operation valid only for density matrices.",
    E.E_INVALID_PROB: "Probabilities must be in [0, 1].",
    E.E_INVALID_ONE_QUBIT_DEPHASE_PROB: "The probability of a single qubit dephase error cannot exceed 1/2, which maximally mixes.",
    E.E_INVALID_TWO_QUBIT_DEPHASE_PROB: "The probability of a two-qubit qubit dephase error cannot exceed 3/4, which maximally mixes.",
    E.E_INVALID_ONE_QUBIT_DEPOL_PROB: "The probability of a single qubit depolarising error cannot exceed 3/4, which maximally mixes.",
    E.E_INVALID_TWO_QUBIT_DEPOL_PROB: "The probability of a two-qubit depolarising error cannot exceed 15/16, which maximally mixes.",
    E.E_INVALID_CONTROLS_BIT_STATE: "The state of the control qubits must be a bit sequence (0s and 1s).",
    E.E_INVALID_NUM_ONE_QUBIT_KRAUS_OPS: "At least 1 and at most 4 single qubit Kraus operators may be specified.",
    E.E_INVALID_NUM_TWO_QUBIT_KRAUS_OPS: "At least 1 and at most 16 two-qubit Kraus operators may be specified.",
    E.E_INVALID_NUM_N_QUBIT_KRAUS_OPS: "At least 1 and at most 4*N^2 of N-qubit Kraus operators may be specified.",
    E.E_INVALID_KRAUS_OPS: "The specified Kraus map is not a completely positive, trace preserving map.",
    E.E_MISMATCHING_NUM_TARGS_KRAUS_SIZE: "Every Kraus operator must be of the same number of qubits as the number of targets.",
    E.E_NUM_AMPS_EXCEED_TYPE: "Too many qubits (max of log2(SIZE_MAX)). Cannot store the number of amplitudes per-node in the size_t type.",
}


class QuESTError(ValueError):
    """Raised for any invalid user input (analogue of invalidQuESTInputError)."""

    def __init__(self, msg, code: ErrorCode = None):
        super().__init__(msg)
        self.code = code


def err(code: ErrorCode):
    """Raise the reference message for `code`."""
    raise QuESTError(MESSAGES[code], code)


def validate_num_qubits(num_qubits: int):
    if not isinstance(num_qubits, (int, np.integer)) or num_qubits < 1:
        err(E.E_INVALID_NUM_CREATE_QUBITS)
    if num_qubits > 60:
        err(E.E_NUM_AMPS_EXCEED_TYPE)


def validate_gate_qubits(num_qubits: int, targets, controls, cstates):
    """The circuit builder's checks, in the reference's order: indices in
    range, targets and controls each unique, disjoint, control states
    bits."""
    for t in targets:
        if not 0 <= t < num_qubits:
            err(E.E_INVALID_TARGET_QUBIT)
    for c in controls:
        if not 0 <= c < num_qubits:
            err(E.E_INVALID_CONTROL_QUBIT)
    if len(set(targets)) != len(targets):
        err(E.E_TARGETS_NOT_UNIQUE)
    if len(set(controls)) != len(controls):
        err(E.E_CONTROLS_NOT_UNIQUE)
    if set(targets) & set(controls):
        err(E.E_CONTROL_TARGET_COLLISION)
    if any(s not in (0, 1) for s in cstates):
        err(E.E_INVALID_CONTROLS_BIT_STATE)


def validate_state_index(qureg, index: int):
    if not 0 <= index < (1 << qureg.num_qubits):
        err(E.E_INVALID_STATE_INDEX)


def validate_amp_index(qureg, index: int, dim: int = None):
    dim = dim if dim is not None else qureg.num_amps
    if not 0 <= index < dim:
        err(E.E_INVALID_AMP_INDEX)


def validate_density_matr(qureg):
    if not qureg.is_density:
        err(E.E_DEFINED_ONLY_FOR_DENSMATRS)


# -- channels (copied from quest_tpu/validation.py:371-448) ------------------

REAL_EPS_SINGLE = 1e-5      # the reference's single-precision REAL_EPS


def validate_kraus_ops(ops, num_targets, eps=REAL_EPS_SINGLE, max_ops=None):
    """Sum_k K+ K == I, i.e. the map is trace-preserving (CPTP)
    (ref QuEST_validation.c:212-239)."""
    ops = list(ops)
    if max_ops is None:
        max_ops = 1 << (2 * num_targets)
    if len(ops) < 1 or len(ops) > max_ops:
        if num_targets == 1:
            err(E.E_INVALID_NUM_ONE_QUBIT_KRAUS_OPS)
        elif num_targets == 2:
            err(E.E_INVALID_NUM_TWO_QUBIT_KRAUS_OPS)
        err(E.E_INVALID_NUM_N_QUBIT_KRAUS_OPS)
    dim = 1 << num_targets
    acc = np.zeros((dim, dim), dtype=np.complex128)
    for op in ops:
        m = np.asarray(op)
        if m.ndim != 2 or m.shape != (dim, dim):
            err(E.E_MISMATCHING_NUM_TARGS_KRAUS_SIZE)
        m = m.astype(np.complex128)
        acc += m.conj().T @ m
    if np.abs(acc - np.eye(dim)).max() > eps:
        err(E.E_INVALID_KRAUS_OPS)


def validate_prob(p: float):
    if not 0 <= p <= 1:
        err(E.E_INVALID_PROB)


def validate_one_qubit_dephase_prob(p: float):
    validate_prob(p)
    if p > 0.5:
        err(E.E_INVALID_ONE_QUBIT_DEPHASE_PROB)


def validate_two_qubit_dephase_prob(p: float):
    validate_prob(p)
    if p > 3.0 / 4.0:
        err(E.E_INVALID_TWO_QUBIT_DEPHASE_PROB)


def validate_one_qubit_depol_prob(p: float):
    validate_prob(p)
    if p > 3.0 / 4.0:
        err(E.E_INVALID_ONE_QUBIT_DEPOL_PROB)


def validate_two_qubit_depol_prob(p: float):
    validate_prob(p)
    if p > 15.0 / 16.0:
        err(E.E_INVALID_TWO_QUBIT_DEPOL_PROB)


def validate_one_qubit_damping_prob(p: float):
    validate_prob(p)


_VALIDATED_KRAUS: set = set()


def _validate_kraus_once(ops, num_targets: int) -> None:
    """validate_kraus_ops memoised by value (ref trajectories.py:49): the
    CPTP check is O(m d^3) host work, and the batched trajectory engine
    plans the same channel many times. One validation per distinct
    (target count, operator values) channel per process."""
    key = (num_targets, tuple((np.shape(K), np.asarray(K).tobytes())
                              for K in ops))
    if key in _VALIDATED_KRAUS:
        return
    validate_kraus_ops(ops, num_targets)
    _VALIDATED_KRAUS.add(key)

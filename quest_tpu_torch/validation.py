"""Input validation: the QuESTError type and the reference codes the
port raises.

The codes and messages are the subset of quest_tpu/validation.py's
verbatim QuEST table (QuEST_validation.c:26-131) that the port's circuit
builder and register constructors raise, with the same numeric values,
so a caller matching on `err.code` sees the same code from either
package.
"""

from __future__ import annotations

import enum

import numpy as np


class ErrorCode(enum.Enum):
    """Reference error codes (values as in QuEST_validation.c:26-79)."""
    E_INVALID_NUM_CREATE_QUBITS = 2
    E_INVALID_TARGET_QUBIT = 4
    E_INVALID_CONTROL_QUBIT = 5
    E_CONTROL_TARGET_COLLISION = 12
    E_TARGETS_NOT_UNIQUE = 14
    E_CONTROLS_NOT_UNIQUE = 15
    E_INVALID_CONTROLS_BIT_STATE = 38
    E_NUM_AMPS_EXCEED_TYPE = 50


E = ErrorCode

MESSAGES = {
    E.E_INVALID_NUM_CREATE_QUBITS: "Invalid number of qubits. Must create >0.",
    E.E_INVALID_TARGET_QUBIT: "Invalid target qubit. Must be >=0 and <numQubits.",
    E.E_INVALID_CONTROL_QUBIT: "Invalid control qubit. Must be >=0 and <numQubits.",
    E.E_CONTROL_TARGET_COLLISION: "Control and target qubits must be disjoint.",
    E.E_TARGETS_NOT_UNIQUE: "The target qubits must be unique.",
    E.E_CONTROLS_NOT_UNIQUE: "The control qubits should be unique.",
    E.E_INVALID_CONTROLS_BIT_STATE: "The state of the control qubits must be a bit sequence (0s and 1s).",
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

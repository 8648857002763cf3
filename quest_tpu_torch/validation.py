"""Input validation: the QuESTError type and the reference codes the
port raises.

The codes and messages are quest_tpu/validation.py's verbatim QuEST
table (QuEST_validation.c:26-131), with the same numeric values, so a
caller matching on `err.code` sees the same code from either package;
the validators below are the reference's, raising the same messages.
Numeric checks take REAL_EPS of the register's precision (eps_for).
"""

from __future__ import annotations

import enum

import numpy as np


class ErrorCode(enum.Enum):
    """Reference error codes (values as in QuEST_validation.c:26-79)."""
    E_SUCCESS = 0
    E_INVALID_NUM_RANKS = enum.auto()
    E_INVALID_NUM_CREATE_QUBITS = enum.auto()
    E_INVALID_QUBIT_INDEX = enum.auto()
    E_INVALID_TARGET_QUBIT = enum.auto()
    E_INVALID_CONTROL_QUBIT = enum.auto()
    E_INVALID_STATE_INDEX = enum.auto()
    E_INVALID_AMP_INDEX = enum.auto()
    E_INVALID_NUM_AMPS = enum.auto()
    E_INVALID_OFFSET_NUM_AMPS = enum.auto()
    E_TARGET_IS_CONTROL = enum.auto()
    E_TARGET_IN_CONTROLS = enum.auto()
    E_CONTROL_TARGET_COLLISION = enum.auto()
    E_QUBITS_NOT_UNIQUE = enum.auto()
    E_TARGETS_NOT_UNIQUE = enum.auto()
    E_CONTROLS_NOT_UNIQUE = enum.auto()
    E_INVALID_NUM_QUBITS = enum.auto()
    E_INVALID_NUM_TARGETS = enum.auto()
    E_INVALID_NUM_CONTROLS = enum.auto()
    E_NON_UNITARY_MATRIX = enum.auto()
    E_NON_UNITARY_COMPLEX_PAIR = enum.auto()
    E_ZERO_VECTOR = enum.auto()
    E_SYS_TOO_BIG_TO_PRINT = enum.auto()
    E_COLLAPSE_STATE_ZERO_PROB = enum.auto()
    E_INVALID_QUBIT_OUTCOME = enum.auto()
    E_CANNOT_OPEN_FILE = enum.auto()
    E_SECOND_ARG_MUST_BE_STATEVEC = enum.auto()
    E_MISMATCHING_QUREG_DIMENSIONS = enum.auto()
    E_MISMATCHING_QUREG_TYPES = enum.auto()
    E_DEFINED_ONLY_FOR_STATEVECS = enum.auto()
    E_DEFINED_ONLY_FOR_DENSMATRS = enum.auto()
    E_INVALID_PROB = enum.auto()
    E_UNNORM_PROBS = enum.auto()
    E_INVALID_ONE_QUBIT_DEPHASE_PROB = enum.auto()
    E_INVALID_TWO_QUBIT_DEPHASE_PROB = enum.auto()
    E_INVALID_ONE_QUBIT_DEPOL_PROB = enum.auto()
    E_INVALID_TWO_QUBIT_DEPOL_PROB = enum.auto()
    E_INVALID_ONE_QUBIT_PAULI_PROBS = enum.auto()
    E_INVALID_CONTROLS_BIT_STATE = enum.auto()
    E_INVALID_PAULI_CODE = enum.auto()
    E_INVALID_NUM_SUM_TERMS = enum.auto()
    E_CANNOT_FIT_MULTI_QUBIT_MATRIX = enum.auto()
    E_INVALID_UNITARY_SIZE = enum.auto()
    E_COMPLEX_MATRIX_NOT_INIT = enum.auto()
    E_INVALID_NUM_ONE_QUBIT_KRAUS_OPS = enum.auto()
    E_INVALID_NUM_TWO_QUBIT_KRAUS_OPS = enum.auto()
    E_INVALID_NUM_N_QUBIT_KRAUS_OPS = enum.auto()
    E_INVALID_KRAUS_OPS = enum.auto()
    E_MISMATCHING_NUM_TARGS_KRAUS_SIZE = enum.auto()
    E_DISTRIB_QUREG_TOO_SMALL = enum.auto()
    E_NUM_AMPS_EXCEED_TYPE = enum.auto()


E = ErrorCode

MESSAGES = {
    E.E_INVALID_NUM_RANKS: "Invalid number of nodes. Distributed simulation can only make use of a power-of-2 number of node.",
    E.E_INVALID_NUM_CREATE_QUBITS: "Invalid number of qubits. Must create >0.",
    E.E_INVALID_QUBIT_INDEX: "Invalid qubit index. Must be >=0 and <numQubits.",
    E.E_INVALID_TARGET_QUBIT: "Invalid target qubit. Must be >=0 and <numQubits.",
    E.E_INVALID_CONTROL_QUBIT: "Invalid control qubit. Must be >=0 and <numQubits.",
    E.E_INVALID_STATE_INDEX: "Invalid state index. Must be >=0 and <2^numQubits.",
    E.E_INVALID_AMP_INDEX: "Invalid amplitude index. Must be >=0 and <2^numQubits.",
    E.E_INVALID_NUM_AMPS: "Invalid number of amplitudes. Must be >=0 and <=2^numQubits.",
    E.E_INVALID_OFFSET_NUM_AMPS: "More amplitudes given than exist in the statevector from the given starting index.",
    E.E_TARGET_IS_CONTROL: "Control qubit cannot equal target qubit.",
    E.E_TARGET_IN_CONTROLS: "Control qubits cannot include target qubit.",
    E.E_CONTROL_TARGET_COLLISION: "Control and target qubits must be disjoint.",
    E.E_QUBITS_NOT_UNIQUE: "The qubits must be unique.",
    E.E_TARGETS_NOT_UNIQUE: "The target qubits must be unique.",
    E.E_CONTROLS_NOT_UNIQUE: "The control qubits should be unique.",
    E.E_INVALID_NUM_QUBITS: "Invalid number of qubits. Must be >0 and <=numQubits.",
    E.E_INVALID_NUM_TARGETS: "Invalid number of target qubits. Must be >0 and <=numQubits.",
    E.E_INVALID_NUM_CONTROLS: "Invalid number of control qubits. Must be >0 and <numQubits.",
    E.E_NON_UNITARY_MATRIX: "Matrix is not unitary.",
    E.E_NON_UNITARY_COMPLEX_PAIR: "Compact matrix formed by given complex numbers is not unitary.",
    E.E_ZERO_VECTOR: "Invalid axis vector. Must be non-zero.",
    E.E_SYS_TOO_BIG_TO_PRINT: "Invalid system size. Cannot print output for systems greater than 5 qubits.",
    E.E_COLLAPSE_STATE_ZERO_PROB: "Can't collapse to state with zero probability.",
    E.E_INVALID_QUBIT_OUTCOME: "Invalid measurement outcome -- must be either 0 or 1.",
    E.E_CANNOT_OPEN_FILE: "Could not open file.",
    E.E_SECOND_ARG_MUST_BE_STATEVEC: "Second argument must be a state-vector.",
    E.E_MISMATCHING_QUREG_DIMENSIONS: "Dimensions of the qubit registers don't match.",
    E.E_MISMATCHING_QUREG_TYPES: "Registers must both be state-vectors or both be density matrices.",
    E.E_DEFINED_ONLY_FOR_STATEVECS: "Operation valid only for state-vectors.",
    E.E_DEFINED_ONLY_FOR_DENSMATRS: "Operation valid only for density matrices.",
    E.E_INVALID_PROB: "Probabilities must be in [0, 1].",
    E.E_UNNORM_PROBS: "Probabilities must sum to ~1.",
    E.E_INVALID_ONE_QUBIT_DEPHASE_PROB: "The probability of a single qubit dephase error cannot exceed 1/2, which maximally mixes.",
    E.E_INVALID_TWO_QUBIT_DEPHASE_PROB: "The probability of a two-qubit qubit dephase error cannot exceed 3/4, which maximally mixes.",
    E.E_INVALID_ONE_QUBIT_DEPOL_PROB: "The probability of a single qubit depolarising error cannot exceed 3/4, which maximally mixes.",
    E.E_INVALID_TWO_QUBIT_DEPOL_PROB: "The probability of a two-qubit depolarising error cannot exceed 15/16, which maximally mixes.",
    E.E_INVALID_ONE_QUBIT_PAULI_PROBS: "The probability of any X, Y or Z error cannot exceed the probability of no error.",
    E.E_INVALID_CONTROLS_BIT_STATE: "The state of the control qubits must be a bit sequence (0s and 1s).",
    E.E_INVALID_PAULI_CODE: "Invalid Pauli code. Codes must be 0 (or PAULI_I), 1 (PAULI_X), 2 (PAULI_Y) or 3 (PAULI_Z) to indicate the identity, X, Y and Z gates respectively.",
    E.E_INVALID_NUM_SUM_TERMS: "Invalid number of terms in the Pauli sum. The number of terms must be >0.",
    E.E_CANNOT_FIT_MULTI_QUBIT_MATRIX: "The specified matrix targets too many qubits; the batches of amplitudes to modify cannot all fit in a single distributed node's memory allocation.",
    E.E_INVALID_UNITARY_SIZE: "The matrix size does not match the number of target qubits.",
    E.E_COMPLEX_MATRIX_NOT_INIT: "The ComplexMatrixN was not successfully created (possibly insufficient memory available).",
    E.E_INVALID_NUM_ONE_QUBIT_KRAUS_OPS: "At least 1 and at most 4 single qubit Kraus operators may be specified.",
    E.E_INVALID_NUM_TWO_QUBIT_KRAUS_OPS: "At least 1 and at most 16 two-qubit Kraus operators may be specified.",
    E.E_INVALID_NUM_N_QUBIT_KRAUS_OPS: "At least 1 and at most 4*N^2 of N-qubit Kraus operators may be specified.",
    E.E_INVALID_KRAUS_OPS: "The specified Kraus map is not a completely positive, trace preserving map.",
    E.E_MISMATCHING_NUM_TARGS_KRAUS_SIZE: "Every Kraus operator must be of the same number of qubits as the number of targets.",
    E.E_DISTRIB_QUREG_TOO_SMALL: "Too few qubits. The created qureg must have at least one amplitude per node used in distributed simulation.",
    E.E_NUM_AMPS_EXCEED_TYPE: "Too many qubits (max of log2(SIZE_MAX)). Cannot store the number of amplitudes per-node in the size_t type.",
}

class QuESTError(ValueError):
    """Raised for any invalid user input (analogue of invalidQuESTInputError)."""

    def __init__(self, msg, code: ErrorCode = None):
        super().__init__(msg)
        self.code = code


def _default_handler(msg: str, func: str = "", code: ErrorCode = None):
    """Call the overridable hook api.invalidQuESTInputError (looked up at
    call time, so replacing that module attribute overrides it, as
    redefining the reference's weak symbol does, QuEST.h:3163-3190),
    then raise QuESTError with the bare message and its code."""
    from quest_tpu_torch import api as _api
    _api.invalidQuESTInputError(msg, func)
    raise QuESTError(msg, code)


_error_handler = _default_handler


def set_error_handler(handler) -> None:
    """Override the invalid-input hook (ref validation.py:168): the
    handler takes (message, function name) and may raise or return;
    None restores the default."""
    global _error_handler
    _error_handler = handler if handler is not None else _default_handler


def _calling_function() -> str:
    """The outermost public quest_tpu_torch function on the stack: the
    one the user called, whose name the reference hands its hook."""
    import inspect
    func = ""
    frame = inspect.currentframe()
    try:
        f = frame.f_back if frame else None
        while f is not None:
            mod = f.f_globals.get("__name__", "")
            name = f.f_code.co_name
            if mod.startswith("quest_tpu_torch") and not name.startswith("_"):
                func = name
            f = f.f_back
    finally:
        del frame
    return func


def err(code, msg: str = None):
    """Report an invalid input through the error handler: the reference
    message for `code`, or a bare message string for a check with no
    reference code. Raises QuESTError when the handler returns."""
    if isinstance(code, ErrorCode):
        msg = MESSAGES[code]
    else:
        code, msg = None, code
    func = _calling_function()
    if _error_handler is _default_handler:
        _default_handler(msg, func, code)
    else:
        _error_handler(msg, func)
    # a handler that returns must not let the operation go on
    raise QuESTError(msg, code)


REAL_EPS_SINGLE = 1e-5      # the reference's REAL_EPS per precision
REAL_EPS_DOUBLE = 1e-13     # (QuEST_precision.h:35,48)


def eps_for(qureg) -> float:
    """REAL_EPS of a register's precision: 1e-5 for f32 planes, 1e-13
    for f64."""
    return REAL_EPS_DOUBLE if qureg.amps.dtype.itemsize == 8 \
        else REAL_EPS_SINGLE


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


# -- registers and qubits (ref quest_tpu/validation.py:200-320) --------------

def validate_num_amps(qureg, start: int, num: int):
    validate_amp_index(qureg, start)
    if num < 0 or num > qureg.num_amps:
        err(E.E_INVALID_NUM_AMPS)
    if start + num > qureg.num_amps:
        err(E.E_INVALID_OFFSET_NUM_AMPS)


def validate_equal_lengths(reals, imags):
    if np.asarray(reals).size != np.asarray(imags).size:
        err("Invalid number of amplitudes: real and imaginary lists must "
            "have equal length.")


def validate_match(a, b):
    if a.num_qubits != b.num_qubits:
        err(E.E_MISMATCHING_QUREG_DIMENSIONS)


def validate_matching_types(a, b):
    if a.is_density != b.is_density:
        err(E.E_MISMATCHING_QUREG_TYPES)


def validate_pure_state_args(qureg, pure):
    if pure.is_density:
        err(E.E_SECOND_ARG_MUST_BE_STATEVEC)
    if qureg.num_qubits != pure.num_qubits:
        err(E.E_MISMATCHING_QUREG_DIMENSIONS)


def validate_state_vector(qureg):
    if qureg.is_density:
        err(E.E_DEFINED_ONLY_FOR_STATEVECS)


def validate_target(qureg, target: int):
    if not 0 <= target < qureg.num_qubits:
        err(E.E_INVALID_TARGET_QUBIT)


def validate_control(qureg, control: int):
    if not 0 <= control < qureg.num_qubits:
        err(E.E_INVALID_CONTROL_QUBIT)


def validate_control_target(qureg, control: int, target: int):
    validate_target(qureg, target)
    validate_control(qureg, control)
    if control == target:
        err(E.E_TARGET_IS_CONTROL)


def validate_unique_targets(qureg, qubit1: int, qubit2: int):
    validate_target(qureg, qubit1)
    validate_target(qureg, qubit2)
    if qubit1 == qubit2:
        err(E.E_QUBITS_NOT_UNIQUE)


def validate_multi_targets(qureg, targets, num_targets=None):
    targets = list(targets)
    n = len(targets) if num_targets is None else num_targets
    if n < 1 or n > qureg.num_qubits:
        err(E.E_INVALID_NUM_TARGETS)
    for t in targets:
        validate_target(qureg, t)
    if len(set(targets)) != len(targets):
        err(E.E_TARGETS_NOT_UNIQUE)


def validate_multi_controls(qureg, controls):
    controls = list(controls)
    if len(controls) >= qureg.num_qubits:
        err(E.E_INVALID_NUM_CONTROLS)
    for c in controls:
        validate_control(qureg, c)
    if len(set(controls)) != len(controls):
        err(E.E_CONTROLS_NOT_UNIQUE)


def validate_multi_controls_targets(qureg, controls, targets):
    validate_multi_controls(qureg, controls)
    validate_multi_targets(qureg, targets)
    if set(controls) & set(targets):
        err(E.E_CONTROL_TARGET_COLLISION)


def validate_control_states(controls, states):
    states = list(states)
    if len(states) != len(list(controls)):
        err(E.E_INVALID_CONTROLS_BIT_STATE)
    for s in states:
        if s not in (0, 1):
            err(E.E_INVALID_CONTROLS_BIT_STATE)


def validate_outcome(outcome: int):
    if outcome not in (0, 1):
        err(E.E_INVALID_QUBIT_OUTCOME)


# -- operators (ref quest_tpu/validation.py:322-368) -------------------------

def _as_matrix(m, num_targets=None) -> np.ndarray:
    m = np.asarray(m)
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        err(E.E_INVALID_UNITARY_SIZE)
    dim = m.shape[0]
    if dim & (dim - 1) or dim < 2:
        err(E.E_INVALID_UNITARY_SIZE)
    if num_targets is not None and dim != (1 << num_targets):
        err(E.E_INVALID_UNITARY_SIZE)
    return m.astype(np.complex128)


def validate_unitary(m, num_targets=None, eps=REAL_EPS_SINGLE):
    """max |U U+ - I| <= eps (ref QuEST_validation.c:166-210)."""
    u = _as_matrix(m, num_targets)
    if np.abs(u @ u.conj().T - np.eye(u.shape[0])).max() > eps:
        err(E.E_NON_UNITARY_MATRIX)


def validate_unitary_complex_pair(alpha, beta, eps=REAL_EPS_SINGLE):
    """|alpha|^2 + |beta|^2 == 1 (ref validateUnitaryComplexPair)."""
    mag = abs(complex(alpha)) ** 2 + abs(complex(beta)) ** 2
    if abs(mag - 1) > eps:
        err(E.E_NON_UNITARY_COMPLEX_PAIR)


def validate_vector(v):
    x, y, z = float(v[0]), float(v[1]), float(v[2])
    if x * x + y * y + z * z < REAL_EPS_SINGLE ** 2:
        err(E.E_ZERO_VECTOR)


# -- Pauli codes, measurement (ref quest_tpu/validation.py:441-471) ----------

def validate_pauli_probs(px: float, py: float, pz: float):
    """Each error probability at most the no-error one (ref
    QuEST_validation.c:487-496)."""
    for p in (px, py, pz):
        validate_prob(p)
    none = 1 - px - py - pz
    if px > none or py > none or pz > none:
        err(E.E_INVALID_ONE_QUBIT_PAULI_PROBS)


def validate_measurement_prob(p: float, eps: float):
    if p < eps:
        err(E.E_COLLAPSE_STATE_ZERO_PROB)


def validate_num_pauli_sum_terms(n: int):
    if n < 1:
        err(E.E_INVALID_NUM_SUM_TERMS)


def validate_pauli_targets(targets, paulis):
    if len(list(targets)) != len(list(paulis)):
        err(E.E_INVALID_PAULI_CODE)


def validate_pauli_codes(codes):
    for c in np.asarray(codes).reshape(-1):
        if int(c) not in (0, 1, 2, 3):
            err(E.E_INVALID_PAULI_CODE)


# -- channels (copied from quest_tpu/validation.py:371-448) ------------------


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

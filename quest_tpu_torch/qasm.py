"""OPENQASM 2.0 circuit logger.

A port of quest_tpu/qasm.py: the recorded text is byte for byte the
reference's (tests/test_torch_qasm.py holds every record_* against it).

Feature-equivalent to the reference's QASM logger (QuEST/src/QuEST_qasm.c):
a per-register growable text buffer seeded with the OPENQASM header
(qasm_setup, QuEST_qasm.c:60-84), recording named gates, parameterized
gates, (multi-)controlled gates, ZYZ-decomposed general unitaries with
global-phase restoration comments, measurements, state initialisations,
and comments for operations QASM cannot express (QuEST_qasm.c:120-504).

The buffer is a Python list of lines (no manual growth logic needed); the
emitted text matches the reference's format: `U(rz2,ry,rz1)` for general
unitaries, `Ctrl-` prefixes per control, `q`/`c` register labels.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

QUREG_LABEL = "q"
MESREG_LABEL = "c"
CTRL_LABEL_PREF = "Ctrl-"
MEASURE_CMD = "measure"
INIT_ZERO_CMD = "reset"
COMMENT_PREF = "//"

GATE_LABELS = {
    "x": "x", "y": "y", "z": "z", "t": "t", "s": "s", "h": "h",
    "rx": "Rx", "ry": "Ry", "rz": "Rz", "u": "U", "phase": "Rz",
    "swap": "swap", "sqrtswap": "sqrtswap",
}


def zyz_angles_from_complex_pair(alpha: complex, beta: complex):
    """(rz2, ry, rz1) Euler angles of U(alpha, beta)
    (ref getZYZRotAnglesFromComplexPair, QuEST_common.c:123-132)."""
    alpha_mag = abs(alpha)
    ry = 2.0 * math.acos(min(1.0, alpha_mag))
    alpha_phase = math.atan2(alpha.imag, alpha.real)
    beta_phase = math.atan2(beta.imag, beta.real)
    return (-alpha_phase + beta_phase, ry, -alpha_phase - beta_phase)


def complex_pair_and_phase_from_unitary(u):
    """Map a 2x2 unitary to exp(i phase) U(alpha, beta)
    (ref getComplexPairAndPhaseFromUnitary, QuEST_common.c:135-147)."""
    u = np.asarray(u, dtype=np.complex128)
    phase = (math.atan2(u[0, 0].imag, u[0, 0].real)
             + math.atan2(u[1, 1].imag, u[1, 1].real)) / 2.0
    rot = complex(math.cos(phase), -math.sin(phase))
    return u[0, 0] * rot, u[1, 0] * rot, phase


def _fmt(x: float) -> str:
    return f"{x:g}"


class QASMLogger:
    """Per-register QASM recorder (ref QASMLogger, QuEST.h:62-69)."""

    def __init__(self, num_qubits: int):
        self.num_qubits = num_qubits
        self.is_logging = False
        self._lines: list[str] = []
        self._header = (f"OPENQASM 2.0;\n"
                        f"qreg {QUREG_LABEL}[{num_qubits}];\n"
                        f"creg {MESREG_LABEL}[{num_qubits}];\n")

    # -- low-level emission --------------------------------------------------

    def _add(self, text: str) -> None:
        self._lines.append(text)

    def _add_gate(self, gate: str, controls: Sequence[int], target: int,
                  params: Sequence[float]) -> None:
        line = CTRL_LABEL_PREF * len(controls) + GATE_LABELS[gate]
        if params:
            line += "(" + ",".join(_fmt(p) for p in params) + ")"
        line += " "
        for c in controls:
            line += f"{QUREG_LABEL}[{c}],"
        line += f"{QUREG_LABEL}[{target}];\n"
        self._add(line)

    # -- recording API (mirrors qasm_record*, QuEST_qasm.h:43-84) ------------

    def record_comment(self, comment: str) -> None:
        if not self.is_logging:
            return
        self._add(f"{COMMENT_PREF} {comment}\n")

    def record_gate(self, gate: str, target: int,
                    controls: Sequence[int] = (), params: Sequence[float] = ()
                    ) -> None:
        if not self.is_logging:
            return
        self._add_gate(gate, tuple(controls), target, tuple(params))
        # restore the global phase of controlled phase shifts
        # (ref qasm_recordControlledParamGate, QuEST_qasm.c:252-258)
        if gate == "phase" and controls:
            self.record_comment("Restoring the discarded global phase of "
                                "the previous controlled phase gate")
            self._add_gate("rz", (), target, (params[0] / 2.0,))

    def record_compact_unitary(self, alpha, beta, target: int,
                               controls: Sequence[int] = ()) -> None:
        if not self.is_logging:
            return
        self._add_gate("u", tuple(controls), target,
                       zyz_angles_from_complex_pair(alpha, beta))

    def record_unitary(self, u, target: int,
                       controls: Sequence[int] = ()) -> None:
        if not self.is_logging:
            return
        alpha, beta, phase = complex_pair_and_phase_from_unitary(u)
        self._add_gate("u", tuple(controls), target,
                       zyz_angles_from_complex_pair(alpha, beta))
        if controls:
            # global phase matters once controlled
            # (ref qasm_recordControlledUnitary, QuEST_qasm.c:282-303)
            self.record_comment("Restoring the discarded global phase of "
                                "the previous controlled unitary")
            self._add_gate("rz", (), target, (phase,))

    def record_axis_rotation(self, angle, axis, target: int,
                             controls: Sequence[int] = ()) -> None:
        if not self.is_logging:
            return
        from quest_tpu_torch.ops.matrices import rotation_pair
        alpha, beta = rotation_pair(angle, axis)
        self._add_gate("u", tuple(controls), target,
                       zyz_angles_from_complex_pair(alpha, beta))

    def record_multi_state_controlled_unitary(
            self, u, controls: Sequence[int], control_states: Sequence[int],
            target: int) -> None:
        if not self.is_logging:
            return
        self.record_comment("NOTing some gates so that the subsequent "
                            "unitary is controlled-on-0")
        for c, s in zip(controls, control_states):
            if s == 0:
                self._add_gate("x", (), c, ())
        self.record_unitary(u, target, tuple(controls))
        self.record_comment("Undoing the NOTing of the controlled-on-0 "
                            "qubits of the previous unitary")
        for c, s in zip(controls, control_states):
            if s == 0:
                self._add_gate("x", (), c, ())

    def record_measurement(self, qubit: int) -> None:
        if not self.is_logging:
            return
        self._add(f"{MEASURE_CMD} {QUREG_LABEL}[{qubit}] -> "
                  f"{MESREG_LABEL}[{qubit}];\n")

    def record_init_zero(self) -> None:
        if not self.is_logging:
            return
        self._add(f"{INIT_ZERO_CMD} {QUREG_LABEL};\n")

    def record_init_plus(self) -> None:
        if not self.is_logging:
            return
        self.record_comment("Initialising state |+>")
        self.record_init_zero()
        self._add(f"h {QUREG_LABEL};\n")

    def record_init_classical(self, state_index: int) -> None:
        if not self.is_logging:
            return
        self.record_comment(f"Initialising state |{state_index}>")
        self.record_init_zero()
        for q in range(self.num_qubits):
            if (state_index >> q) & 1:
                self._add_gate("x", (), q, ())

    # -- control (ref QuEST.c:85-104) ----------------------------------------

    def start_recording(self) -> None:
        self.is_logging = True

    def stop_recording(self) -> None:
        self.is_logging = False

    def clear(self) -> None:
        self._lines.clear()

    def recorded(self) -> str:
        return self._header + "".join(self._lines)

    def print_recorded(self) -> None:
        print(self.recorded(), end="")

    def write_recorded_to_file(self, filename: str) -> bool:
        try:
            with open(filename, "w") as f:
                f.write(self.recorded())
            return True
        except OSError:
            return False
